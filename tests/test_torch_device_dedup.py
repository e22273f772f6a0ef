"""The port's MeshDedupIndex (plain versions on the CPU) vs the JAX
``MeshDedupIndex``: the cases of ``tests/test_device_dedup.py``.

Each side gets its own JAX ``BlobIndex`` as host authority, seeded alike
(the port takes any object with ``__len__``, ``queued_count``,
``known_hashes()`` and ``is_duplicate``).  Tolerance 0: every flag must be
equal, and where both sides made the same inserts the raw table layouts
too.
"""

import random

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from backuwup_tpu.crypto import KeyManager
from backuwup_tpu.ops.backend import CpuBackend
from backuwup_tpu.ops.blake3_cpu import blake3_hash
from backuwup_tpu.ops.gear import CDCParams
from backuwup_tpu.snapshot.blob_index import BlobIndex
from backuwup_tpu.snapshot.device_dedup import MeshDedupIndex as RefIndex
from backuwup_tpu.snapshot.packer import DirPacker
from backuwup_tpu.snapshot.packfile import PackfileWriter
from backuwup_tpu_torch.snapshot.device_dedup import MeshDedupIndex

SHARDS = [1, 8]


@pytest.fixture(scope="module")
def meshes():
    return {d: Mesh(np.array(jax.devices()[:d]), ("data",)) for d in SHARDS}


@pytest.fixture
def hosts(tmp_path):
    keys = KeyManager.from_secret(b"\x07" * 32)
    return (BlobIndex(keys, tmp_path / "index_port"),
            BlobIndex(keys, tmp_path / "index_ref"))


def _pair(meshes, hosts, d, capacity):
    return (MeshDedupIndex(hosts[0], n_shards=d, capacity=capacity,
                           device="cpu"),
            RefIndex(meshes[d], hosts[1], capacity=capacity))


def _same_table(dev, ref):
    assert dev.capacity == ref.capacity
    assert np.array_equal(dev.sharded.keys.numpy().view(np.uint32),
                          np.asarray(ref.sharded.keys))
    assert np.array_equal(dev.sharded.values.numpy().view(np.uint32),
                          np.asarray(ref.sharded.values))


def _hashes(n, seed=0):
    return [blake3_hash(f"{seed}:{i}".encode()) for i in range(n)]


@pytest.mark.parametrize("d", SHARDS)
def test_classify_matches_host(meshes, hosts, d):
    dev, ref = _pair(meshes, hosts, d, 256)
    hs = _hashes(100)
    flags = dev.classify_insert(hs)
    assert flags == ref.classify_insert(hs)
    for h, f in zip(hs, flags):
        assert f == hosts[0].is_duplicate(h)  # all new
        for host in hosts:
            host.mark_queued(h)
    _same_table(dev, ref)
    flags2 = dev.classify_insert(hs)
    assert all(flags2) and flags2 == ref.classify_insert(hs)


def test_intra_batch_repeats(meshes, hosts):
    dev, ref = _pair(meshes, hosts, 8, 256)
    hs = _hashes(5, seed=1)
    batch = [hs[0], hs[1], hs[0], hs[2], hs[1], hs[0]]
    flags = dev.classify_insert(batch)
    assert flags == [False, False, True, False, True, True]
    assert flags == ref.classify_insert(batch)


@pytest.mark.parametrize("d", SHARDS)
def test_seeded_from_host(meshes, hosts, d):
    pre = _hashes(20, seed=2)
    for host in hosts:
        for h in pre[:10]:
            host.mark_queued(h)
        host.finalize_packfile(b"\x01" * 12, pre[10:15])
    dev, ref = _pair(meshes, hosts, d, 256)
    flags = dev.classify_insert(pre)
    assert flags == [True] * 15 + [False] * 5
    assert flags == ref.classify_insert(pre)


def test_streamed_chunks_synced_before_next_classify(meshes, tmp_path):
    """The JAX packer driven by the port's classify_insert: a chunk first
    seen via the streaming path must reach the device table before the
    next batch classify (no device/host divergence), as with the JAX
    index."""
    keys = KeyManager.from_secret(b"\x08" * 32)
    params = CDCParams.from_desired(4096)
    big = random.Random(21).randbytes(200_000)
    src = tmp_path / "src"
    src.mkdir()
    (src / "a_big.bin").write_bytes(big)
    (src / "b_pre.bin").write_bytes(big[:50_000])
    stats = []
    for name in ("port", "ref"):
        index = BlobIndex(keys, tmp_path / f"index_{name}")
        dev = (MeshDedupIndex(index, n_shards=8, capacity=1024, device="cpu")
               if name == "port" else RefIndex(meshes[8], index,
                                               capacity=1024))
        writer = PackfileWriter(keys, tmp_path / f"pack_{name}",
                                on_packfile=lambda pid, path, hashes, size,
                                index=index: index.finalize_packfile(
                                    pid, hashes))
        packer = DirPacker(CpuBackend(params), writer, index,
                           batch_bytes=100_000,
                           dedup_batch=dev.classify_insert)
        packer.pack(src)
        stats.append(packer.stats)
    port_stats, ref_stats = stats
    assert port_stats.dedup_divergences == 0
    assert port_stats.chunks_deduped > 0
    assert port_stats.chunks_deduped == ref_stats.chunks_deduped


@pytest.mark.parametrize("d", SHARDS)
def test_grows_under_pressure(meshes, hosts, d):
    dev, ref = _pair(meshes, hosts, d, 8)
    hs = _hashes(600, seed=3)
    flags, ref_flags = [], []
    for s in range(0, len(hs), 64):
        batch = hs[s:s + 64]
        flags.extend(dev.classify_insert(batch))
        ref_flags.extend(ref.classify_insert(batch))
        for host in hosts:
            for h in batch:
                host.mark_queued(h)
    assert flags == ref_flags
    assert not any(flags)
    assert dev.capacity > 8 and dev.capacity == ref.capacity
    _same_table(dev, ref)
    assert all(dev.classify_insert(hs))


@pytest.mark.parametrize("d", SHARDS)
def test_resolve_hints_matches(meshes, hosts, d):
    """Per-occurrence device flags with repeats and unclassified (None)
    occurrences: the host authority answers for the poisoned hashes,
    which are re-inserted into the table."""
    dev, ref = _pair(meshes, hosts, d, 256)
    hs = _hashes(12, seed=4)
    for host in hosts:
        host.mark_queued(hs[0])
        host.mark_queued(hs[5])
    seq = [hs[0], hs[1], hs[1], hs[2], hs[3], hs[5], hs[4], hs[2], hs[6],
           hs[7], hs[5]]
    raw = [True, False, False, None, False, None, False, False, True,
           False, None]
    flags = dev.resolve_hints(seq, raw)
    assert flags == ref.resolve_hints(seq, raw)
    assert flags == [True, False, True, False, False, True, False, True,
                     True, False, True]
    assert dev.resolve_hints([], []) == []
    _same_table(dev, ref)
