"""The port's CUDA kernels and GPU path on the card (marked ``cuda``).

Each test skips here, where torch has no CUDA.  This file imports no JAX
and nothing of ``backuwup_tpu``, so on a machine with a card and without
JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from backuwup_tpu_torch.erasure import gf_cpu, rs_gpu
from backuwup_tpu_torch.ops import (
    blake3_gpu,
    dedup_index,
    pallas_kernels,
    scan_fused,
)
from backuwup_tpu_torch.ops.backend import CpuBackend, GpuBackend
from backuwup_tpu_torch.ops.gear import CDCParams


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_scan_kernel_matches_plain():
    _needs_card()
    rng = np.random.default_rng(3)
    P = 1 << 20
    ext = torch.from_numpy(rng.integers(0, 256, (3, 31 + P), dtype=np.uint8))
    nv = torch.tensor([P, P - 12345, 77], dtype=torch.int32)
    ext_d, nv_d = ext.cuda(), nv.cuda()
    before = scan_fused.candidate_words.launches
    for mask_s, mask_l in ((0xFFF00000, 0xFFF80000), (0xFFFFC000, 0xFFF00000)):
        got = scan_fused.candidate_words(ext_d, nv_d, mask_s, mask_l)
        want = scan_fused.candidate_words_plain(ext_d, nv_d, mask_s, mask_l)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert scan_fused.candidate_words.launches == before + 2


@pytest.mark.cuda
def test_scan_kernel_edge_shapes_match_plain():
    """Bit-exact with the plain version: P = 32; widths that are no
    multiple of one thread's run of 128 positions (the last run passes the
    row's end) or cross a block; valid lengths 0, 1, 31, 33 and P; 16 rows
    of unequal valid lengths with an all-zero row; rows starting at each
    byte alignment; both CDCParams masks, the 64 KiB masks and a loose
    pair that sets many bits."""
    _needs_card()
    rng = np.random.default_rng(34)
    masks = [(CDCParams().mask_s, CDCParams().mask_l),
             (CDCParams.from_desired(64 * 1024).mask_s,
              CDCParams.from_desired(64 * 1024).mask_l),
             (0xF0000000, 0xC0000000)]
    shapes = []
    for P in (32, 32 * 13, 256 * 128 + 96):
        shapes.append((P, [0, 1, 31, min(33, P), P]))
    P16 = 64 * 1024 + 32
    shapes.append((P16, [P16 - 777 * r for r in range(16)]))
    for P, nvs in shapes:
        B = len(nvs)
        for offset in range(4):
            flat = torch.from_numpy(rng.integers(
                0, 256, offset + B * (31 + P), dtype=np.uint8)).cuda()
            ext = flat[offset:].view(B, 31 + P)
            if B == 16:
                ext[3] = 0
            nv = torch.tensor(nvs, dtype=torch.int32, device="cuda")
            for mask_s, mask_l in masks:
                before = scan_fused.candidate_words.launches
                got = scan_fused.candidate_words(ext, nv, mask_s, mask_l)
                want = scan_fused.candidate_words_plain(ext, nv, mask_s,
                                                        mask_l)
                torch.cuda.synchronize()
                assert scan_fused.candidate_words.launches == before + 1
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (P, offset, mask_l)


@pytest.mark.cuda
def test_leaf_kernel_matches_plain():
    _needs_card()
    rng = np.random.default_rng(13)
    lanes = 70_001
    words = torch.from_numpy(rng.integers(
        0, 2**32, (lanes, 256), dtype=np.uint64).astype(np.uint32).view(
        np.int32)).cuda()
    nb = torch.from_numpy(rng.integers(0, 17, lanes).astype(np.int32)).cuda()
    lbl = torch.from_numpy(rng.integers(0, 65, lanes).astype(np.int32)).cuda()
    ctr = torch.from_numpy(rng.integers(0, 9000, lanes).astype(np.int32)).cuda()
    got = blake3_gpu.leaf_scan(words, nb, lbl, ctr)
    want = blake3_gpu.leaf_scan_plain(words, nb, lbl, ctr)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_gpu_backend_matches_oracle_backend():
    _needs_card()
    params = CDCParams.from_desired(4096)
    rng = np.random.default_rng(21)
    streams = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
               for n in (0, 1, 700, 5000, 40_000, 65_536, 300_000)]
    streams.append(bytes(30_000))
    gpu = GpuBackend(params, strict_overflow=True)
    gpu.pipeline.scanner.segment_size = 128 * 1024
    assert gpu.device.type == "cuda"
    assert gpu.manifest_many(streams) == CpuBackend(params).manifest_many(
        streams)


@pytest.mark.cuda
def test_gear_values_kernel_matches_plain():
    _needs_card()
    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.integers(0, 256, (1 << 20) + 12345,
                                         dtype=np.uint8)).cuda()
    # whole 4-byte groups and a tail of 1 or 3 values; an odd byte offset
    for b in (data[:1], data[:17], data[:4099], data, data[3:]):
        got = pallas_kernels.gear_values(b)
        want = pallas_kernels.gear_values_plain(b)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_ladder_kernel_matches_plain():
    _needs_card()
    rng = np.random.default_rng(6)
    n = 3 * pallas_kernels.LADDER_BLOCK
    g = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint64).astype(
        np.uint32).view(np.int32)).cuda()
    for mask_s, mask_l, n_valid in ((0xFFFFFC00, 0xFFFF0000, n),
                                    (0xFFFFC000, 0xFFF00000, n - 4321)):
        got = pallas_kernels.ladder_candidates(g, n_valid, mask_s=mask_s,
                                               mask_l=mask_l)
        want = pallas_kernels.ladder_candidates_plain(
            g, n_valid, mask_s=mask_s, mask_l=mask_l)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert int(got[0].sum()) > 0


@pytest.mark.cuda
def test_gear_values_kernel_offsets_and_lengths():
    """Bit-exact with the plain version at every byte offset 0-15 and
    every length 0-64 (a tail of 0-3 values after whole 4-byte groups),
    and at 1 MiB + 12,345 from each offset; one launch per non-empty
    call."""
    _needs_card()
    rng = np.random.default_rng(35)
    long_n = (1 << 20) + 12345
    data = torch.from_numpy(rng.integers(0, 256, 16 + long_n,
                                         dtype=np.uint8)).cuda()
    for offset in range(16):
        for length in [*range(65), long_n]:
            b = data[offset:offset + length]
            before = pallas_kernels.gear_values.launches
            got = pallas_kernels.gear_values(b)
            want = pallas_kernels.gear_values_plain(b)
            assert torch.equal(got, want), (offset, length)
            assert pallas_kernels.gear_values.launches == before + (
                length > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 3])
def test_ladder_kernel_valid_boundaries_match_plain(blocks):
    """Bit-exact with the plain version for n_valid at 0, 1, 31, 33 and
    around every boundary of the kernel's schedule (a thread's run of 16
    positions, a warp's span of 512, a block of 4,096, a ladder block)
    and n; the CDCParams() masks, the 64 KiB masks and a
    loose pair that sets a quarter of the flags; gear values of real
    bytes and random words, and an input 4 bytes off a 16-byte
    boundary."""
    _needs_card()
    rng = np.random.default_rng(36 + blocks)
    n = blocks * pallas_kernels.LADDER_BLOCK
    data = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).cuda()
    words = torch.from_numpy(rng.integers(0, 2**32, n + 1, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).cuda()
    inputs = [pallas_kernels.gear_values(data), words[:n], words[1:]]
    masks = [(CDCParams().mask_s, CDCParams().mask_l),
             (CDCParams.from_desired(64 * 1024).mask_s,
              CDCParams.from_desired(64 * 1024).mask_l),
             (0xF0000000, 0xC0000000)]
    n_valids = {0, 1, 31, 33, n - 1, n, n + 1, -5}
    for edge in (16, 512, 4096, pallas_kernels.LADDER_BLOCK):
        for k in range(1, min(n // edge, 3) + 1):
            n_valids.update((k * edge - 1, k * edge, k * edge + 1))
    for g in inputs:
        for mask_s, mask_l in masks:
            for n_valid in sorted(n_valids):
                before = pallas_kernels.ladder_candidates.launches
                got = pallas_kernels.ladder_candidates(
                    g, n_valid, mask_s=mask_s, mask_l=mask_l)
                want = pallas_kernels.ladder_candidates_plain(
                    g, n_valid, mask_s=mask_s, mask_l=mask_l)
                assert pallas_kernels.ladder_candidates.launches == before + 1
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (n, mask_l, n_valid)
    assert int(want[0].sum()) > n // 8  # the loose pair sets many flags


def _clone(idx):
    return dataclasses.replace(idx, keys=idx.keys.clone(),
                               values=idx.values.clone())


@pytest.mark.cuda
def test_dedup_kernel_matches_plain_under_races():
    """A 4,096-key insert batch in which 64 distinct keys share one start
    slot (so lanes still race after the retry rounds), with repeats,
    resident keys and padding rows: found, lost and the whole tables are
    bit-identical to the plain version; then probe and growth."""
    _needs_card()
    rng = np.random.default_rng(7)
    cap = 1 << 14
    idx = dedup_index.ShardedDedupIndex.create(1, capacity=cap,
                                               max_probes=128)
    pre = rng.integers(1, 2**32, (2048, 4), dtype=np.uint64).astype(np.uint32)
    idx.insert(pre, np.arange(2048, dtype=np.uint32))
    q = rng.integers(1, 2**32, (4096, 4), dtype=np.uint64).astype(np.uint32)
    q[:64, 1] = (q[:64, 1] // cap) * cap + 77  # one start slot
    q[100:140] = q[200:240]                   # intra-batch repeats
    q[300:340] = pre[:40]                     # already resident
    q[400:404] = 0                            # padding
    q_d = torch.from_numpy(q.view(np.int32)).cuda()
    v_d = torch.arange(4096, dtype=torch.int32, device="cuda") + 5000
    plain = _clone(idx)
    before = dedup_index.insert_table.launches
    found, lost = idx.insert_device(q_d, v_d)
    f_p, l_p = dedup_index.insert_table_plain(
        plain.keys, plain.values, q_d, v_d, max_probes=plain.max_probes)
    torch.cuda.synchronize()
    assert dedup_index.insert_table.launches == before + 1
    assert torch.equal(found, f_p) and torch.equal(lost, l_p)
    assert torch.equal(idx.keys, plain.keys)
    assert torch.equal(idx.values, plain.values)
    assert int((lost == dedup_index.LOST_RACE).sum()) >= 53
    assert int((found != 0).sum()) == 40
    assert torch.equal(idx.claim, torch.full_like(idx.claim, -1))
    probe = torch.cat([q_d, torch.from_numpy(pre.view(np.int32)).cuda()])
    assert torch.equal(idx.probe_device(probe), dedup_index.probe_table_plain(
        idx.keys, idx.values, probe, max_probes=idx.max_probes))
    before = dedup_index.migrate_round.launches
    grown = idx.grown(4 * cap)
    assert dedup_index.migrate_round.launches == before + 1
    nk = torch.zeros_like(grown.keys)
    nv = torch.zeros_like(grown.values)
    rounds, exhausted = dedup_index.migrate_plain(
        idx.keys, idx.values, nk, nv, max_probes=idx.max_probes).tolist()
    assert not exhausted
    assert torch.equal(grown.keys, nk) and torch.equal(grown.values, nv)
    assert torch.equal(grown.claim, torch.full_like(grown.claim, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("racing", [1, 2, 5, 63])
def test_dedup_insert_rounds_match_plain(racing):
    """``racing + 1`` distinct keys share one start slot beside 40 keys
    on other slots and padding rows: lanes race in exactly ``racing``
    rounds (63: past the 10 retry rounds, 53 lanes left LOST_RACE).  One
    kernel launch; the per-round race counts it leaves in the index's
    scratch say how many rounds ran; found, lost and the whole tables
    equal the plain version's, and the claim vector is all -1 after the
    call."""
    _needs_card()
    cap = 1 << 12
    rng = np.random.default_rng(50 + racing)
    q = rng.integers(1, 2**32, (racing + 1 + 40, 4),
                     dtype=np.uint64).astype(np.uint32)
    q[:, 1] = (q[:, 1] // cap) * cap + 200
    q[racing + 1:, 1] -= np.arange(40, dtype=np.uint32) * 3 + 80
    q = np.vstack([q, np.zeros((3, 4), dtype=np.uint32)])
    q = q[rng.permutation(len(q))]
    q_d = torch.from_numpy(q.view(np.int32)).cuda()
    v_d = torch.arange(len(q), dtype=torch.int32, device="cuda") + 9000
    idx = dedup_index.ShardedDedupIndex.create(1, capacity=cap,
                                               max_probes=128)
    plain = _clone(idx)
    before = dedup_index.insert_table.launches
    found, lost = idx.insert_device(q_d, v_d)
    f_p, l_p = dedup_index.insert_table_plain(
        plain.keys, plain.values, q_d, v_d, max_probes=plain.max_probes)
    torch.cuda.synchronize()
    assert dedup_index.insert_table.launches == before + 1
    races = idx.scratch.races.tolist()
    assert races == [max(racing - r, 0) for r in range(len(races))]
    assert idx.scratch.rounds_run() == min(racing + 1, len(races))
    assert torch.equal(found, f_p) and torch.equal(lost, l_p)
    assert torch.equal(idx.keys, plain.keys)
    assert torch.equal(idx.values, plain.values)
    assert int((lost == dedup_index.LOST_RACE).sum()) \
        == max(racing + 1 - len(races), 0)
    assert torch.equal(idx.claim, torch.full_like(idx.claim, -1))


def _run_keys(rng, n, d, cap, start):
    """``n`` distinct keys of shard ``3 % d`` whose first slot in a table
    of ``cap`` slots is ``start``."""
    q = rng.integers(1, 2**32, (n, 4), dtype=np.uint64).astype(np.uint32)
    q[:, 0] = q[:, 0] // d * d + 3 % d
    q[:, 1] = (q[:, 1] // cap) * cap + start
    return q


def _migrate_both(idx, new_cap):
    """The kernel's migration (one launch) and the plain one of the same
    old table; returns the kernel's (rounds, exhausted), having checked
    the new tables bit-identical and the claim vector all -1."""
    d = idx.n_shards
    nk = torch.zeros((d, new_cap, 4), dtype=torch.int32, device="cuda")
    nv = torch.zeros((d, new_cap), dtype=torch.int32, device="cuda")
    claim = torch.full((d * new_cap,), -1, dtype=torch.int32, device="cuda")
    pk, pv = nk.clone(), nv.clone()
    before = dedup_index.migrate_round.launches
    got = dedup_index.migrate_round(idx.keys, idx.values, nk, nv,
                                    max_probes=idx.max_probes,
                                    claim=claim).tolist()
    assert dedup_index.migrate_round.launches == before + 1
    want = dedup_index.migrate_plain(idx.keys, idx.values, pk, pv,
                                     max_probes=idx.max_probes).tolist()
    assert got == want
    assert torch.equal(nk, pk) and torch.equal(nv, pv)
    assert torch.equal(claim, torch.full_like(claim, -1))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("d, cap, new_cap", [(1, 4096, 16384),
                                             (8, 512, 2048),
                                             (1, 1000, 2500),
                                             (8, 1000, 1001)])
def test_dedup_migration_matches_plain(d, cap, new_cap):
    """A race-heavy growth: 48 keys of one shard share their first slot
    in the old and the new table, beside keys at load ~0.4, so every
    round places one of them (48 rounds); on 1 and 8 shards, at
    capacities that are and are not powers of two.  One launch per
    growth, tables bit-identical to the plain migration's, the claim
    vector all -1 after it; ``grown()`` gives the same tables."""
    _needs_card()
    rng = np.random.default_rng(d * 7 + cap)
    idx = dedup_index.ShardedDedupIndex.create(d, capacity=cap,
                                               max_probes=128)
    run = _run_keys(rng, 48, d, int(np.lcm(cap, new_cap)), 200)
    rest = rng.integers(1, 2**32, (d * cap * 4 // 10, 4),
                        dtype=np.uint64).astype(np.uint32)
    q = np.vstack([run, rest])
    idx.insert(q, np.arange(len(q), dtype=np.uint32) + 11)
    rounds, exhausted = _migrate_both(idx, new_cap)
    assert rounds >= 48 and not exhausted
    before = dedup_index.migrate_round.launches
    grown = idx.grown(new_cap)
    assert dedup_index.migrate_round.launches == before + 1
    assert torch.equal(grown.claim, torch.full_like(grown.claim, -1))
    q_d = torch.from_numpy(q.view(np.int32)).cuda()
    assert torch.equal(grown.probe_device(q_d),
                       torch.arange(len(q), dtype=torch.int32,
                                    device="cuda") + 12)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8])
def test_dedup_migration_exhausted_raises(d):
    """Walks cut to one slot cannot place a run of keys that share a
    first slot: the kernel reports exhaustion as the plain migration
    does, with the same partial table; ``grown()`` raises DedupIndexFull
    and leaves the old table intact."""
    _needs_card()
    rng = np.random.default_rng(70 + d)
    idx = dedup_index.ShardedDedupIndex.create(d, capacity=64,
                                               max_probes=64)
    q = np.vstack([_run_keys(rng, 8, d, 64 * 65, 5),
                   rng.integers(1, 2**32, (20 * d, 4),
                                dtype=np.uint64).astype(np.uint32)])
    idx.insert(q, np.arange(len(q), dtype=np.uint32))
    small = dataclasses.replace(idx, max_probes=1)
    rounds, exhausted = _migrate_both(small, 65)
    assert exhausted == 1 and rounds >= 1
    keys0, vals0 = idx.keys.clone(), idx.values.clone()
    before = dedup_index.migrate_round.launches
    with pytest.raises(dedup_index.DedupIndexFull):
        small.grown(65)
    assert dedup_index.migrate_round.launches == before + 1
    assert torch.equal(idx.keys, keys0) and torch.equal(idx.values, vals0)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1, 3, 5, 64, 1000])
@pytest.mark.parametrize("d", [1, 8])
def test_dedup_probe_windows_wrap(d, cap):
    """Probe groups whose windows wrap at the end of the shard (runs of
    keys from the shard's last slots; shards smaller than a group), with
    padding rows, unseen keys on the run's first slot and stored values
    of 0xFFFFFFFF (found wraps to 0), at max_probes 1, 5, 33 and 64: the
    kernel equals the plain probe, one launch a call."""
    _needs_card()
    rng = np.random.default_rng(80 + cap + d)
    idx = dedup_index.ShardedDedupIndex.create(d, capacity=cap,
                                               max_probes=cap + 8)
    n_run = max(1, min(12, cap - 1))
    run = _run_keys(rng, n_run, d, cap, cap - 1)
    rest = rng.integers(1, 2**32, (d * cap // 4, 4),
                        dtype=np.uint64).astype(np.uint32)
    rest[:, 0] = np.arange(len(rest))  # one per shard in turn: none full
    q = np.vstack([run, rest])
    vals = np.arange(len(q), dtype=np.uint32)
    vals[::3] = 0xFFFFFFFF
    idx.insert(q, vals)
    probe = np.vstack([q, np.zeros((5, 4), dtype=np.uint32),
                       _run_keys(rng, 6, d, cap, cap - 1),
                       rng.integers(1, 2**32, (100, 4),
                                    dtype=np.uint64).astype(np.uint32)])
    probe_d = torch.from_numpy(probe.view(np.int32)).cuda()
    for max_probes in (1, 5, 33, 64):
        view = dataclasses.replace(idx, max_probes=max_probes)
        before = dedup_index.probe_table.launches
        got = view.probe_device(probe_d)
        assert dedup_index.probe_table.launches == before + 1
        want = dedup_index.probe_table_plain(idx.keys, idx.values, probe_d,
                                             max_probes=max_probes)
        assert torch.equal(got, want), max_probes
    assert int((got[len(q):len(q) + 5] != 0).sum()) == 0
    with pytest.raises(ValueError):  # the kernel loads rows as uint4
        dedup_index.probe_table(idx.keys, idx.values,
                                probe_d.view(-1)[1:-3].view(-1, 4),
                                max_probes=8)


@pytest.mark.cuda
@pytest.mark.parametrize("ln", [4096, 4097, 1, 33])
def test_gf_matmul_kernel_matches_plain(ln):
    """K6 on RS(4, 2) encode and decode at 64 stripes of 4 rows (4096 as
    the reference's accelerator case, odd L, L = 1 and a two-unit L),
    against the plain version on the card and the numpy oracle."""
    _needs_card()
    rng = np.random.default_rng(60 + ln)
    k, m = 4, 2
    stripes = rng.integers(0, 256, (64, k, ln), dtype=np.uint8)
    before = rs_gpu.gf_matmul.launches
    parity = rs_gpu.encode_stripes(stripes, m)
    assert rs_gpu.gf_matmul.launches == before + 1
    expect = np.stack([gf_cpu.encode_stripe(s, m) for s in stripes])
    assert np.array_equal(parity, expect)
    present = list(range(m, k + m))
    full = np.concatenate([stripes, parity], axis=1)
    dec = rs_gpu.decode_stripes(full[:, present, :], k, m, present)
    assert np.array_equal(dec, stripes)
    mat = torch.from_numpy(gf_cpu.generator_matrix(k, m)[k:].copy()).cuda()
    x = torch.from_numpy(stripes).cuda()
    got = rs_gpu.gf_matmul(mat, x)
    want = rs_gpu.gf_matmul_plain(mat, x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("r,nj,ln", [(9, 3, 100), (17, 16, 35),
                                     (128, 128, 20), (255, 1, 7)])
def test_gf_matmul_kernel_other_geometries(r, nj, ln):
    """More output rows than one register tile, the full 64 KiB table
    (r * J > 256, the shared-memory opt-in) and a tall matrix; inputs
    offset by 1-3 bytes from an aligned allocation."""
    _needs_card()
    rng = np.random.default_rng(r * 7 + nj)
    mat = rng.integers(0, 256, (r, nj), dtype=np.uint8)
    stripes = rng.integers(0, 256, (3, nj, ln), dtype=np.uint8)
    want = np.stack([gf_cpu.gf_matmul(mat, s) for s in stripes])
    assert np.array_equal(rs_gpu.gf_matmul_stripes(mat, stripes), want)
    for shift in (1, 2, 3):
        buf = torch.zeros(stripes.size + shift, dtype=torch.uint8,
                          device="cuda")
        buf[shift:] = torch.from_numpy(stripes.reshape(-1)).cuda()
        x = buf[shift:].view(stripes.shape)
        got = rs_gpu.gf_matmul(torch.from_numpy(mat).cuda(), x)
        torch.cuda.synchronize()
        assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_gpu_backend_erasure_launches_k6():
    _needs_card()
    from backuwup_tpu_torch.erasure import stripe

    data = np.random.default_rng(61).bytes(3 * 1024 * 1024 + 5)
    gpu, cpu = GpuBackend(), CpuBackend()
    before = rs_gpu.gf_matmul.launches
    containers = stripe.split_packfile(data, 4, 2, gpu)
    assert containers == stripe.split_packfile(data, 4, 2, cpu)
    assert stripe.assemble_packfile(containers[2:], gpu) == data
    rebuilt = stripe.rebuild_shards(containers[1:5], [0, 5], gpu)
    assert rebuilt == {0: containers[0], 5: containers[5]}
    # split 1, assemble 1, rebuild: decode + encode
    assert rs_gpu.gf_matmul.launches == before + 4


def test_engine_without_cuda_raises(tmp_path, monkeypatch):
    """``Engine(..., backend=None)`` takes ``select_backend()``, the GPU:
    without CUDA it raises instead of dropping to the CPU."""
    from backuwup_tpu_torch.crypto import KeyManager
    from backuwup_tpu_torch.engine import Engine
    from backuwup_tpu_torch.store import Store

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = Store(tmp_path / "cfg", data_base=tmp_path / "data")
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(KeyManager.from_secret(b"\x01" * 32), store, None, None)
    finally:
        store.close()


@pytest.mark.cuda
def test_dev_time_times_cuda_tensors_with_events(monkeypatch):
    _needs_card()
    from backuwup_tpu_torch.obs import profile

    made = []
    event = torch.cuda.Event

    def counting_event(*args, **kw):
        made.append(kw.get("enable_timing"))
        return event(*args, **kw)

    monkeypatch.setattr(torch.cuda, "Event", counting_event)
    x = torch.ones(1 << 22, dtype=torch.float32, device="cuda")
    dt = profile.dev_time(lambda t: t * 2.0, x, n=10)
    assert 0 < dt < 1.0
    assert made == [True, True]


@pytest.mark.cuda
def test_engine_backs_up_and_restores_on_the_card(tmp_path):
    """``Engine(..., backend=GpuBackend())`` backs an ~8 MiB tree up to
    six loopback holders as RS(4, 2) stripes and restores it onto a fresh
    store byte-identical; its tiered front's K5 insert, the scan (K1), the
    leaf hash (K2) and the GF(2^8) product (K6) all launch."""
    _needs_card()
    import asyncio
    import hashlib

    from backuwup_tpu_torch import defaults
    from backuwup_tpu_torch.crypto import KeyManager
    from backuwup_tpu_torch.engine import Engine
    from backuwup_tpu_torch.net.client import ServerClient
    from backuwup_tpu_torch.net.p2p import (P2PNode, ReceivedFilesWriter,
                                            Receiver)
    from backuwup_tpu_torch.net.server import CoordinationServer
    from backuwup_tpu_torch.store import Store

    rng = np.random.default_rng(71)
    src = tmp_path / "src"
    for i in range(8):
        p = src / f"d{i % 3}" / f"f{i}.bin"
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(rng.bytes(1 << 20))
    (src / "copy.bin").write_bytes((src / "d0" / "f0.bin").read_bytes())

    def digest(root):
        return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
                .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}

    kernels = (scan_fused.candidate_words, blake3_gpu.leaf_scan,
               dedup_index.insert_table, rs_gpu.gf_matmul)
    before = [k.launches for k in kernels]

    async def client(name, secret, addr, hold):
        keys = KeyManager.from_secret(secret)
        store = Store(tmp_path / name / "cfg",
                      data_base=tmp_path / name / "data")
        store.set_obfuscation_key(secret[:4])
        c = ServerClient(keys, store, addr=addr, tls=False)
        node = P2PNode(keys, store, c)
        if hold:
            async def accept(source, transport):
                w = ReceivedFilesWriter(store, source)
                await Receiver(transport, w.sink, part_sink=w.sink_part,
                               resume_query=w.resume_offer).run()
            node.on_transport_request = accept
            node.on_restore_request = node.serve_restore
        await c.register()
        await c.login()
        c.start_ws()
        await asyncio.wait_for(c.ws_connected.wait(), 10)
        return keys, store, c, node

    async def run():
        server = CoordinationServer(db_path=str(tmp_path / "server.db"))
        addr = f"127.0.0.1:{await server.start()}"
        made = []
        try:
            holders = [await client(f"h{i}", bytes([0x60 + i]) * 32, addr,
                                    True) for i in range(6)]
            made += holders
            keys, store, c, node = await client("owner", b"\x31" * 32, addr,
                                                False)
            made.append((keys, store, c, node))
            for hk, hs, _c, _n in holders:
                store.add_peer_negotiated(hk.client_id, 64 << 20)
                hs.add_peer_negotiated(keys.client_id, 64 << 20)
                server.db.save_storage_negotiated(keys.client_id,
                                                  hk.client_id, 64 << 20)
            eng = Engine(keys, store, c, node, backend=GpuBackend())
            assert eng.device_dedup is not None
            assert eng.device_dedup.device.type == "cuda"
            await eng.recover()
            await eng.run_backup(src)
            # stripes of RS_K + RS_M shards (a packfile can go out whole
            # when two admission ticks race for a holder's dial)
            assert set(range(defaults.RS_K + defaults.RS_M)) <= \
                {i for *_r, i, _t in store.all_placements()}
            await c.close()
            _k, store2, c2, node2 = await client("owner2", b"\x31" * 32,
                                                 addr, False)
            made.append((_k, store2, c2, node2))
            eng2 = Engine(keys, store2, c2, node2, backend=GpuBackend())
            await eng2.recover()
            dest = await eng2.run_restore(tmp_path / "restored")
            assert digest(dest) == digest(src)
        finally:
            for _k, s, cl, _n in made:
                await cl.close()
                s.close()
            await server.stop()

    asyncio.run(asyncio.wait_for(run(), 300))
    torch.cuda.synchronize()
    assert all(k.launches > b for k, b in zip(kernels, before))
