"""The port's erasure stripes vs the JAX package's: the non-network cases
of ``tests/test_erasure.py``, each run through both packages, plus
cross-package cases and a numpy model of the K6 kernel's schedule.

The port runs its ``GpuBackend(device="cpu")`` (the plain versions of K6
and of the BLAKE3 leaf kernel) and its ``CpuBackend`` (the numpy oracle);
the reference runs its ``CpuBackend``.  Every container, payload, matrix
and wire encoding is held equal at tolerance 0, and each package reads
the other's containers and shard trees.
"""

import itertools
import random

import numpy as np
import pytest

from backuwup_tpu import wire as ref_wire
from backuwup_tpu.erasure import gf_cpu as ref_gf
from backuwup_tpu.erasure import rs_tpu
from backuwup_tpu.erasure import stripe as ref_stripe
from backuwup_tpu.ops.backend import CpuBackend as RefCpuBackend
from backuwup_tpu.ops.gear import CDCParams as RefCDCParams
from backuwup_tpu.snapshot.packfile import packfile_path as ref_packfile_path
from backuwup_tpu.store import Store as RefStore
from backuwup_tpu_torch import defaults, wire
from backuwup_tpu_torch.erasure import gf_cpu, rs_gpu
from backuwup_tpu_torch.erasure import stripe as rs_stripe
from backuwup_tpu_torch.ops.backend import CpuBackend, GpuBackend
from backuwup_tpu_torch.ops.gear import CDCParams
from backuwup_tpu_torch.snapshot.packfile import packfile_path
from backuwup_tpu_torch.store import Store

REF = RefCpuBackend(RefCDCParams.from_desired(4096))
PORT = GpuBackend(CDCParams.from_desired(4096), device="cpu")
PORT_ORACLE = CpuBackend(CDCParams.from_desired(4096))
M32 = 0xFFFFFFFF


@pytest.fixture(params=["port", "ref"])
def store(request, tmp_path):
    cls = Store if request.param == "port" else RefStore
    s = cls(tmp_path / "cfg", data_base=tmp_path / "data")
    s.set_obfuscation_key(b"\xaa\x01\x7f\x33")
    yield s
    s.close()


def _slow_gf_mul(a: int, b: int) -> int:
    """Russian-peasant multiply mod 0x11d -- independent of the tables."""
    out = 0
    while b:
        if b & 1:
            out ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11D
        b >>= 1
    return out


def _k6_gf_mul(a: int, b: int) -> int:
    """``gf_mul`` of ``csrc/gf_matmul.cu``, step for step: eight rounds,
    reducing on the 0x80 bit before the shift."""
    p = 0
    for _ in range(8):
        p ^= a if b & 1 else 0
        b >>= 1
        a = ((a << 1) ^ (0x11D if a & 0x80 else 0)) & M32
    return p


# --------------------------------------------------------------------------
# GF(2^8) oracle: field algebra
# --------------------------------------------------------------------------


def test_mul_table_matches_peasant_multiply(rng):
    for _ in range(500):
        a, b = rng.randrange(256), rng.randrange(256)
        assert gf_cpu.gf_mul(a, b) == _slow_gf_mul(a, b) == \
            ref_gf.gf_mul(a, b)
    assert np.array_equal(gf_cpu.MUL_TABLE, ref_gf.MUL_TABLE)
    assert np.array_equal(gf_cpu.GF_EXP, ref_gf.GF_EXP)
    assert np.array_equal(gf_cpu.GF_LOG[1:], ref_gf.GF_LOG[1:])
    # the kernel builds its tables with its own multiply: all 65536 pairs
    k6 = np.array([[_k6_gf_mul(a, b) for b in range(256)]
                   for a in range(256)], dtype=np.uint8)
    assert np.array_equal(k6, gf_cpu.MUL_TABLE)


def test_gf_inverse_property():
    for gf in (gf_cpu, ref_gf):
        with pytest.raises(ZeroDivisionError):
            gf.gf_inv(0)
    for a in range(1, 256):
        assert gf_cpu.gf_mul(a, gf_cpu.gf_inv(a)) == 1
        assert gf_cpu.gf_inv(a) == ref_gf.gf_inv(a)


def test_generator_every_k_submatrix_invertible():
    k, m = defaults.RS_K, defaults.RS_M
    gen = gf_cpu.generator_matrix(k, m)
    assert np.array_equal(gen, ref_gf.generator_matrix(k, m))
    assert np.array_equal(gen[:k], np.eye(k, dtype=np.uint8))  # systematic
    for rows in itertools.combinations(range(k + m), k):
        inv = gf_cpu.gf_invert_matrix(gen[list(rows)])
        assert np.array_equal(inv, ref_gf.gf_invert_matrix(gen[list(rows)]))
        prod = gf_cpu.gf_matmul(inv, gen[list(rows)])
        assert np.array_equal(prod, np.eye(k, dtype=np.uint8))
        assert np.array_equal(gf_cpu.decode_matrix(k, m, rows),
                              ref_gf.decode_matrix(k, m, rows))
    for k2, m2 in ((1, 0), (2, 1), (5, 3), (16, 16), (128, 128)):
        assert np.array_equal(gf_cpu.generator_matrix(k2, m2),
                              ref_gf.generator_matrix(k2, m2))


def test_generator_rejects_bad_geometry():
    for gf in (gf_cpu, ref_gf):
        with pytest.raises(ValueError):
            gf.generator_matrix(0, 2)
        with pytest.raises(ValueError):
            gf.generator_matrix(200, 100)


def test_reconstruct_rebuilds_exact_rows(nprng):
    k, m = 4, 2
    data = nprng.integers(0, 256, (k, 64), dtype=np.uint8)
    gen = gf_cpu.generator_matrix(k, m)
    shards = {i: gf_cpu.gf_matmul(gen[i:i + 1], data)[0]
              for i in range(k + m)}
    survivors = {i: shards[i] for i in (1, 3, 4, 5)}
    rebuilt = gf_cpu.reconstruct(survivors, k, m, missing=[0, 2])
    want = ref_gf.reconstruct(survivors, k, m, missing=[0, 2])
    assert np.array_equal(rebuilt[0], shards[0])
    assert np.array_equal(rebuilt[2], shards[2])
    assert all(np.array_equal(rebuilt[i], want[i]) for i in (0, 2))


# --------------------------------------------------------------------------
# stripe containers: any-k-of-n round trip + corruption detection
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k,m", [(2, 1), (3, 2), (4, 2), (5, 3)])
def test_any_k_of_n_round_trip_every_subset(k, m, rng):
    data = rng.randbytes(k * 97 + 13)  # deliberately not a multiple of k
    containers = rs_stripe.split_packfile(data, k, m, PORT)
    assert containers == ref_stripe.split_packfile(data, k, m, REF)
    assert len(containers) == k + m
    for subset in itertools.combinations(range(k + m), k):
        got = rs_stripe.assemble_packfile(
            [containers[i] for i in subset], PORT)
        assert got == data


@pytest.mark.parametrize("size", [0, 1, 4, 4 * 97])
def test_round_trip_edge_sizes(size, rng):
    data = rng.randbytes(size)
    containers = rs_stripe.split_packfile(data, 4, 2, PORT)
    assert containers == ref_stripe.split_packfile(data, 4, 2, REF)
    assert rs_stripe.assemble_packfile(containers[2:], PORT) == data
    assert rs_stripe.assemble_packfile(containers[2:], PORT_ORACLE) == data


def test_split_is_deterministic(rng):
    data = rng.randbytes(1000)
    assert rs_stripe.split_packfile(data, 4, 2, PORT) == \
        rs_stripe.split_packfile(data, 4, 2, PORT) == \
        rs_stripe.split_packfile(data, 4, 2, PORT_ORACLE)


def test_corrupted_shard_detected_and_survived(rng):
    data = rng.randbytes(5000)
    containers = rs_stripe.split_packfile(data, 4, 2, PORT)
    bad = bytearray(containers[1])
    bad[rs_stripe.HEADER_LEN + 5] ^= 0xFF  # flip one payload byte
    bad = bytes(bad)
    blobs = [bad] + [containers[i] for i in (0, 2, 3, 4)]
    shards, geom, drops = rs_stripe.collect_shards(blobs, PORT)
    ref_shards, ref_geom, ref_drops = ref_stripe.collect_shards(blobs, REF)
    assert geom == ref_geom == (4, 2, len(data))
    assert 1 not in shards  # the poisoned shard never reaches the solve
    assert any("digest mismatch" in d for d in drops)
    assert drops == ref_drops and sorted(shards) == sorted(ref_shards)
    got = rs_stripe.assemble_packfile(
        [bad, containers[0], containers[2], containers[3], containers[4]],
        PORT)
    assert got == data
    with pytest.raises(rs_stripe.StripeError, match="need 4"):
        rs_stripe.assemble_packfile(
            [bad, containers[0], containers[2], containers[3]], PORT)


def test_parse_shard_rejects_malformed_containers(rng):
    data = rng.randbytes(256)
    good = rs_stripe.split_packfile(data, 2, 1, PORT)[0]
    cases = ((b"NOPE" + good[4:], "not a shard"),
             (good[:4] + bytes([99]) + good[5:], "version"),
             (good[:6] + b"\x00" + good[7:], "geometry"),  # k = 0
             (good + b"extra", "length mismatch"))
    for blob, msg in cases:
        with pytest.raises(rs_stripe.StripeError, match=msg) as port_err:
            rs_stripe.parse_shard(blob)
        with pytest.raises(ref_stripe.StripeError) as ref_err:
            ref_stripe.parse_shard(blob)
        assert str(port_err.value) == str(ref_err.value)
    port, ref = rs_stripe.parse_shard(good), ref_stripe.parse_shard(good)
    assert vars(port) == vars(ref)


def test_shard_id_round_trip():
    pid = bytes(range(12))
    sid = rs_stripe.shard_id(pid, 5)
    assert sid == ref_stripe.shard_id(pid, 5)
    assert len(sid) == wire.SHARD_ID_LEN == rs_stripe.SHARD_ID_LEN
    assert rs_stripe.parse_shard_id(sid) == (pid, 5)
    with pytest.raises(rs_stripe.StripeError, match="length"):
        rs_stripe.parse_shard_id(pid)


def test_rebuild_shards_byte_identical(rng):
    data = rng.randbytes(3333)
    containers = rs_stripe.split_packfile(data, 4, 2, PORT)
    survivors = [containers[i] for i in (1, 2, 4, 5)]
    rebuilt = rs_stripe.rebuild_shards(survivors, [0, 3], PORT)
    assert rebuilt[0] == containers[0]
    assert rebuilt[3] == containers[3]
    assert rebuilt == ref_stripe.rebuild_shards(survivors, [0, 3], REF)
    with pytest.raises(rs_stripe.StripeError):
        rs_stripe.rebuild_shards(containers[:3], [4], PORT)  # < k left


def test_assemble_tree_reconstructs_and_reports(tmp_path, rng):
    data = rng.randbytes(4000)
    pid_ok, pid_bad = b"\x01" * 12, b"\x02" * 12
    containers = rs_stripe.split_packfile(data, 4, 2, PORT)
    shard_root = tmp_path / "shard"
    ok_dir = shard_root / pid_ok.hex()
    ok_dir.mkdir(parents=True)
    for i in (0, 2, 3, 5):  # any 4 of 6
        (ok_dir / f"{i:03d}").write_bytes(containers[i])
    bad_dir = shard_root / pid_bad.hex()
    bad_dir.mkdir(parents=True)
    for i in (0, 1):  # below k: must be reported, not crash the walk
        (bad_dir / f"{i:03d}").write_bytes(containers[i])
    done, failed = rs_stripe.assemble_tree(shard_root, tmp_path / "pack",
                                           PORT)
    assert done == [pid_ok]
    assert [pid for pid, _ in failed] == [pid_bad]
    assert packfile_path(tmp_path / "pack", pid_ok).read_bytes() == data
    ref_done, ref_failed = ref_stripe.assemble_tree(
        shard_root, tmp_path / "ref_pack", REF)
    assert (ref_done, ref_failed) == (done, failed)
    assert ref_packfile_path(tmp_path / "ref_pack", pid_ok).relative_to(
        tmp_path / "ref_pack") == packfile_path(
        tmp_path / "pack", pid_ok).relative_to(tmp_path / "pack")


# --------------------------------------------------------------------------
# backend routing: the oracle, the plain device product and the reference
# --------------------------------------------------------------------------


def test_cpu_backend_encode_decode_matches_oracle(nprng):
    k, m = 4, 2
    stripes = nprng.integers(0, 256, (3, k, 128), dtype=np.uint8)
    expect = np.stack([gf_cpu.encode_stripe(s, m) for s in stripes])
    full = np.concatenate([stripes, expect], axis=1)
    present = [0, 2, 4, 5]
    for be in (PORT, PORT_ORACLE, REF):
        parity = be.encode_shards(stripes, m)
        assert parity.dtype == np.uint8 and np.array_equal(parity, expect)
        dec = be.decode_shards(full[:, present, :], k, m, present)
        assert dec.dtype == np.uint8 and np.array_equal(dec, stripes)


def test_device_kernel_matches_oracle_on_host(nprng):
    # rs_gpu's plain version on the CPU, rs_tpu's jit(vmap) gather on the
    # CPU and the numpy oracle, bit for bit, over every k-subset
    k, m = defaults.RS_K, defaults.RS_M
    stripes = nprng.integers(0, 256, (4, k, 256), dtype=np.uint8)
    parity = rs_gpu.encode_stripes(stripes, m, device="cpu")
    expect = np.stack([gf_cpu.encode_stripe(s, m) for s in stripes])
    assert np.array_equal(parity, expect)
    assert np.array_equal(np.asarray(rs_tpu.encode_stripes(stripes, m)),
                          expect)
    full = np.concatenate([stripes, parity], axis=1)
    for present in itertools.combinations(range(k + m), k):
        survivors = full[:, list(present), :]
        dec = rs_gpu.decode_stripes(survivors, k, m, list(present),
                                    device="cpu")
        assert np.array_equal(dec, stripes), f"survivors {present}"
        ref = np.asarray(rs_tpu.decode_stripes(survivors, k, m,
                                               list(present)))
        assert np.array_equal(dec, ref), f"survivors {present}"


# --------------------------------------------------------------------------
# store: shard_index schema + deterministic peer ordering (both packages)
# --------------------------------------------------------------------------


def test_store_shard_placement_round_trip(store):
    pid, pa, pb = b"\x0e" * 12, b"\x61" * 32, b"\x62" * 32
    store.record_placement(pid, pa, 100, shard_index=0)
    store.record_placement(pid, pb, 100, shard_index=1)
    store.record_placement(pid, pa, 100, shard_index=2)
    assert store.shard_placements_for_peer(pa) == [(pid, 100, 0)]
    assert sorted(store.shards_for_packfile(pid)) == \
        sorted([(pa, 0), (pb, 1)])
    assert store.retire_placement(pid, pa) == 1
    assert store.shards_for_packfile(pid) == [(pb, 1)]
    assert store.retire_placement(pid, pa) == 0  # idempotent


def test_store_legacy_placement_reads_as_whole(store):
    pid, peer = b"\x0f" * 12, b"\x63" * 32
    store.record_placement(pid, peer, 500)  # pre-erasure call shape
    assert store.shard_placements_for_peer(peer) == [(pid, 500, -1)]
    assert store.shards_for_packfile(pid) == [(peer, -1)]


def test_find_peers_with_storage_tie_break_is_deterministic(store):
    hi, lo = b"\x02" * 32, b"\x01" * 32
    store.add_peer_negotiated(hi, 1000)
    store.add_peer_negotiated(lo, 1000)  # equal free space
    assert [p.pubkey for p in store.find_peers_with_storage()] == [lo, hi]


# --------------------------------------------------------------------------
# wire: 13-byte shard ids + geometry fields (encodings equal the reference's)
# --------------------------------------------------------------------------


def test_shard_file_frame_round_trip():
    sid = rs_stripe.shard_id(b"\x07" * 12, 5)
    frames = []
    for w in (wire, ref_wire):
        body = w.P2PBody(
            kind=w.P2PBodyKind.FILE,
            header=w.P2PHeader(sequence_number=3,
                               session_nonce=b"\x01" * w.TRANSPORT_NONCE_LEN),
            file_info=w.FileInfoKind.SHARD, file_id=sid, data=b"container")
        frames.append(body.encode_bytes())
        out = w.P2PBody.decode_bytes(frames[-1])
        assert out.file_info == w.FileInfoKind.SHARD
        assert out.file_id == sid and out.data == b"container"
    assert frames[0] == frames[1]


def test_audit_ids_accept_shards_reject_other_lengths():
    sid = rs_stripe.shard_id(b"\x07" * 12, 0)
    c = wire.StorageChallenge(packfile_id=sid, offset=0, length=16,
                              nonce=b"\x00" * wire.AUDIT_NONCE_LEN)
    assert c.packfile_id == sid
    wire.StorageProof(packfile_id=b"\x07" * 12,
                      status=wire.ProofStatus.OK)  # legacy id still fine
    with pytest.raises(ValueError, match="12 or 13 bytes"):
        wire.StorageChallenge(packfile_id=b"\x07" * 11, offset=0, length=1,
                              nonce=b"\x00" * wire.AUDIT_NONCE_LEN)


def test_backup_request_min_peers_round_trip():
    msg = wire.BackupRequest(session_token=b"\x01" * 16,
                             storage_required=123, min_peers=6)
    assert msg.to_json() == ref_wire.BackupRequest(
        session_token=b"\x01" * 16, storage_required=123,
        min_peers=6).to_json()
    out = wire.JsonMessage.from_json(msg.to_json())
    assert out.storage_required == 123 and out.min_peers == 6
    assert wire.BackupRequest(session_token=b"\x01" * 16,
                              storage_required=1).min_peers == 1


def test_backup_restore_info_advertises_geometry():
    msg = wire.BackupRestoreInfo(snapshot_hash=b"\x0a" * 32,
                                 peers=["ff" * 32], rs_k=4, rs_m=2)
    assert msg.to_json() == ref_wire.BackupRestoreInfo(
        snapshot_hash=b"\x0a" * 32, peers=["ff" * 32], rs_k=4,
        rs_m=2).to_json()
    out = wire.JsonMessage.from_json(msg.to_json())
    assert (out.rs_k, out.rs_m) == (4, 2)
    assert wire.BackupRestoreInfo().rs_k == 0


# --------------------------------------------------------------------------
# cross-package: each package's containers and trees in the other
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k,m,size", [(4, 2, 0), (4, 2, 1), (4, 2, 3 << 16),
                                      (4, 2, 123_457), (1, 3, 999),
                                      (6, 0, 5000), (10, 6, 77_777)])
def test_split_containers_equal_the_reference(k, m, size):
    data = random.Random(size + 7 * k + m).randbytes(size)
    want = ref_stripe.split_packfile(data, k, m, REF)
    assert rs_stripe.split_packfile(data, k, m, PORT) == want
    assert rs_stripe.split_packfile(data, k, m, PORT_ORACLE) == want


@pytest.mark.parametrize("direction", ["port_reads_ref", "ref_reads_port"])
def test_assemble_and_rebuild_accept_the_other_packages_containers(
        direction):
    k, m = defaults.RS_K, defaults.RS_M
    data = random.Random(11).randbytes(54_321)
    if direction == "port_reads_ref":
        containers = ref_stripe.split_packfile(data, k, m, REF)
        mod, be = rs_stripe, PORT
    else:
        containers = rs_stripe.split_packfile(data, k, m, PORT)
        mod, be = ref_stripe, REF
    for n_drop in range(m + 1):
        for dropped in itertools.combinations(range(k + m), n_drop):
            kept = [containers[i] for i in range(k + m) if i not in dropped]
            assert mod.assemble_packfile(kept, be) == data
            if dropped:
                rebuilt = mod.rebuild_shards(kept, list(dropped), be)
                assert rebuilt == {i: containers[i] for i in dropped}


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_assemble_tree_reads_the_other_packages_tree(tmp_path, writer):
    """One package writes the shard tree (as ``RestoreFilesWriter`` lays
    it out), the other assembles it; both assemble it the same way."""
    rng = random.Random(5)
    split, be = ((rs_stripe.split_packfile, PORT) if writer == "port"
                 else (ref_stripe.split_packfile, REF))
    shard_root = tmp_path / "shard"
    datas = {}
    for n, size in enumerate((0, 1, 4000, 70_001)):
        pid = bytes([n + 1]) * 12
        datas[pid] = rng.randbytes(size)
        d = shard_root / pid.hex()
        d.mkdir(parents=True)
        for i, blob in enumerate(split(datas[pid], 4, 2, be)):
            if i != n % 6 and i != (n + 3) % 6:  # two of six missing
                (d / f"{i:03d}").write_bytes(blob)
    done, failed = rs_stripe.assemble_tree(shard_root, tmp_path / "p", PORT)
    ref_done, ref_failed = ref_stripe.assemble_tree(shard_root,
                                                    tmp_path / "r", REF)
    assert done == ref_done == sorted(datas) and failed == ref_failed == []
    for pid, data in datas.items():
        assert packfile_path(tmp_path / "p", pid).read_bytes() == data
        assert ref_packfile_path(tmp_path / "r", pid).read_bytes() == data


# --------------------------------------------------------------------------
# rs_gpu's contracts and the plain version's tiling
# --------------------------------------------------------------------------


def test_rs_gpu_edge_contracts(nprng, monkeypatch):
    x = nprng.integers(0, 256, (2, 4, 33), dtype=np.uint8)
    launches = rs_gpu.gf_matmul.launches
    out = rs_gpu.encode_stripes(x, 0, device="cpu")
    assert out.shape == (2, 0, 33) and out.dtype == np.uint8
    out = rs_gpu.encode_stripes(x[:0], 2, device="cpu")
    assert out.shape == (0, 2, 33) and out.dtype == np.uint8
    assert rs_gpu.decode_stripes(x[:0], 4, 2, [0, 1, 2, 3],
                                 device="cpu").shape == (0, 4, 33)
    # present is deduplicated and sorted, whatever order it comes in
    full = np.concatenate([x, rs_gpu.encode_stripes(x, 2, device="cpu")], 1)
    got = rs_gpu.decode_stripes(full[:, [1, 2, 4, 5], :], 4, 2,
                                [5, 2, 4, 1, 2], device="cpu")
    assert np.array_equal(got, x)
    # strided inputs (a view of survivors, a [None] view) are taken as is
    parity = rs_gpu.encode_stripes(full[0][None, :4], 2, device="cpu")
    assert np.array_equal(parity[0], full[0, 4:])
    # the plain version over many tiles of L equals one tile
    monkeypatch.setattr(rs_gpu, "_PLAIN_TILE", 7)
    assert np.array_equal(rs_gpu.encode_stripes(x, 2, device="cpu"),
                          full[:, 4:])
    assert rs_gpu.gf_matmul.launches == launches  # the CPU never counts
    with pytest.raises(ValueError):
        rs_gpu.gf_matmul_stripes(np.zeros((2, 3), np.uint8), x, "cpu")


def test_entry_points_need_cuda_unless_asked_for_the_cpu(nprng):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    x = nprng.integers(0, 256, (1, 4, 8), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        rs_gpu.encode_stripes(x, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        rs_gpu.decode_stripes(x, 4, 2, [0, 1, 2, 3])
    with pytest.raises(RuntimeError, match="CUDA"):
        GpuBackend()


# --------------------------------------------------------------------------
# numpy model of K6's schedule (csrc/gf_matmul.cu)
# --------------------------------------------------------------------------


def _funnel_r(lo, hi, s):
    return ((hi << 32 | lo) >> s) & M32


def _funnel_l(lo, hi, s):
    return (((hi << 32 | lo) << s) >> 32) & M32


def _word(mem, a):
    return int.from_bytes(bytes(mem[a:a + 4]), "little")


def _load16(mem, a, row_end):
    if a % 16 == 0 and a + 16 <= row_end:
        return [_word(mem, a + 4 * k) for k in range(4)]
    w0, s = a & ~3, 8 * (a & 3)
    v = [_word(mem, w0 + 4 * k) if w0 + 4 * k < row_end else 0
         for k in range(5)]
    return [_funnel_r(v[k], v[k + 1], s) for k in range(4)]


def _store_word(mem, base, t0, n, w):
    if t0 >= 0 and t0 + 4 <= n:
        assert (base + t0) % 4 == 0
        mem[base + t0:base + t0 + 4] = list(w.to_bytes(4, "little"))
        return
    for q in range(4):
        if 0 <= t0 + q < n:
            mem[base + t0 + q] = (w >> (8 * q)) & 0xFF


def _store16(mem, a, v, n):
    if a % 16 == 0 and n == 16:
        for k in range(4):
            mem[a + 4 * k:a + 4 * k + 4] = list(v[k].to_bytes(4, "little"))
        return
    sh = a & 3
    s = 8 * sh
    words = [_funnel_l(0, v[0], s), _funnel_l(v[0], v[1], s),
             _funnel_l(v[1], v[2], s), _funnel_l(v[2], v[3], s)]
    for k, w in enumerate(words):
        _store_word(mem, a, 4 * k - sh, n, w)
    if sh:
        _store_word(mem, a, 16 - sh, n, _funnel_l(v[3], 0, s))


def _k6_model(mat, stripes, row_tile=8):
    """The kernel's arithmetic and addressing in numpy: the rows or full
    product table built with its multiply, 16-byte column units, inputs
    through aligned words and funnel shifts, outputs through aligned words
    and edge bytes into a buffer whose other bytes must stay untouched."""
    r, nj = mat.shape
    nb, _, ln = stripes.shape
    full = r * nj > 256
    if full:
        tab = [_k6_gf_mul(a, x) for a in range(256) for x in range(256)]
    else:
        tab = [_k6_gf_mul(int(mat.reshape(-1)[p]), x)
               for p in range(r * nj) for x in range(256)]
    mem_in = np.zeros(stripes.size + 32, dtype=np.uint8)
    mem_in[:stripes.size] = stripes.reshape(-1)
    mem_out = np.full(nb * r * ln + 32, 0xEE, dtype=np.uint8)
    chunks = -(-ln // 16)
    for u in range(nb * chunks):
        b = u // chunks
        c = (u - b * chunks) * 16
        n = min(16, ln - c)
        for i0 in range(0, r, row_tile):
            acc = [[0] * 4 for _ in range(row_tile)]
            for j in range(nj):
                row = (b * nj + j) * ln
                x = _load16(mem_in, row + c, row + ln)
                for q in range(row_tile):
                    i = i0 + q
                    if i >= r:
                        continue
                    t = (int(mat[i, j]) if full else i * nj + j) << 8
                    for k in range(4):
                        look = sum(tab[t + ((x[k] >> (8 * e)) & 0xFF)]
                                   << (8 * e) for e in range(4))
                        acc[q][k] ^= look
            for q in range(row_tile):
                i = i0 + q
                if i < r:
                    _store16(mem_out, (b * r + i) * ln + c, acc[q], n)
    assert (mem_out[nb * r * ln:] == 0xEE).all(), "wrote past the output"
    return mem_out[:nb * r * ln].reshape(nb, r, ln)


@pytest.mark.parametrize("r,nj,nb,ln", [
    (2, 4, 2, 1), (2, 4, 2, 3), (2, 4, 1, 16), (4, 4, 2, 17), (4, 4, 1, 37),
    (9, 3, 2, 21), (17, 16, 1, 19), (1, 1, 3, 5)])
def test_k6_schedule_model_matches_the_oracle(r, nj, nb, ln):
    """Rows path (r * J <= 256) and full path (17 x 16), more output rows
    than one register tile (9), L = 1, odd L and unaligned rows: the
    model of the kernel equals ``gf_cpu`` and the plain version."""
    import torch

    g = np.random.default_rng(r * 1000 + nj * 10 + ln)
    mat = g.integers(0, 256, (r, nj), dtype=np.uint8)
    stripes = g.integers(0, 256, (nb, nj, ln), dtype=np.uint8)
    want = np.stack([gf_cpu.gf_matmul(mat, s) for s in stripes])
    assert np.array_equal(_k6_model(mat, stripes), want)
    plain = rs_gpu.gf_matmul_plain(torch.from_numpy(mat),
                                   torch.from_numpy(stripes)).numpy()
    assert np.array_equal(plain, want)
