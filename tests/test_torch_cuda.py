"""The port's CUDA kernels and GPU path on the card (marked ``cuda``).

Each test skips here, where torch has no CUDA.  This file imports no JAX
and nothing of ``backuwup_tpu``, so on a machine with a card and without
JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

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
    import dataclasses
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
    grown = idx.grown(4 * cap)
    pending = (idx.keys != 0).any(dim=2).reshape(-1).to(torch.uint8)
    nk = torch.zeros_like(grown.keys)
    nv = torch.zeros_like(grown.values)
    while True:
        more, exhausted = dedup_index.migrate_round_plain(
            idx.keys, idx.values, nk, nv, pending,
            max_probes=idx.max_probes)
        assert not exhausted
        if not more:
            break
    assert torch.equal(grown.keys, nk) and torch.equal(grown.values, nv)


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
