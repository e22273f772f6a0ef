"""The slice as a whole: the port's ``DirPacker`` over ``GpuBackend``
(plain versions on the CPU) with its tiered dedup front vs the JAX
package's ``DirPacker`` over ``CpuBackend`` with its ``TieredDedupIndex``:
the cases of ``tests/test_snapshot.py``, plus one that carries a
reference front across mid-run (``carry.tiered_from_reference``).

The port's front classifies each chunk batch in one pass on the device
(``classify_dispatch`` + ``resolve_hints``), the reference's in two
(``classify_insert``).  Both fronts have 8 shards under a budget of 64
hot slots, so the tier split (recency, cold runs) is live.  Each package
packs under ``os.urandom`` patched onto a seeded source started afresh
with the same seed (blob nonces, packfile ids).  Tolerance 0: snapshot
roots, pack statistics, every packfile's bytes and each restore must be
equal, and each package restores from the other's packfiles.
"""

import io
import os
import random
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from backuwup_tpu import defaults as ref_defaults
from backuwup_tpu.crypto import KeyManager as RefKeyManager
from backuwup_tpu.dedupstore import TieredDedupIndex as RefTiered
from backuwup_tpu.ops.backend import CpuBackend
from backuwup_tpu.ops.gear import CDCParams as RefParams
from backuwup_tpu.snapshot import blob_index as ref_blob_index
from backuwup_tpu.snapshot import packer as ref_packer
from backuwup_tpu.snapshot import packfile as ref_packfile
from backuwup_tpu.snapshot import unpacker as ref_unpacker
from backuwup_tpu_torch import carry, defaults
from backuwup_tpu_torch.crypto import KeyManager
from backuwup_tpu_torch.dedupstore import TieredDedupIndex
from backuwup_tpu_torch.obs import metrics as obs_metrics
from backuwup_tpu_torch.ops.backend import CpuBackend as PortCpuBackend
from backuwup_tpu_torch.ops.backend import GpuBackend
from backuwup_tpu_torch.ops.gear import CDCParams
from backuwup_tpu_torch.snapshot import blob_index, packer, packfile, unpacker

SECRET = bytes(range(32))
SHARDS = 8
BUDGET = SHARDS * 8 * 20
MTIME = 1_600_000_000_000_000_000


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:SHARDS]), ("data",))


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    # the packer's lag bound emits a partial packfile once blobs have
    # waited PACK_EMIT_MAX_LAG_S of wall time, which moves packfile
    # boundaries with the host's speed: off here, so that the two
    # packages' packfiles can be compared byte for byte
    for d in (defaults, ref_defaults):
        monkeypatch.setattr(d, "PACK_EMIT_MAX_LAG_S", float("inf"))
    obs_metrics.registry().reset()
    yield
    obs_metrics.registry().reset()


class Engine:
    """One package's packer, authority, front, writer and restore."""

    def __init__(self, port: bool, root: Path, mesh, front=True,
                 index=None, batch_bytes=None, one_pass=True):
        self.port = port
        self.root = Path(root)
        km, bi, pf = ((KeyManager, blob_index, packfile) if port else
                      (RefKeyManager, ref_blob_index, ref_packfile))
        self.keys = km.from_secret(SECRET)
        self.index = index or bi.BlobIndex(self.keys, self.root / "index")
        self.added = []  # blob hashes the writer was given
        self.writer = pf.PackfileWriter(
            self.keys, self.root / "pack",
            on_packfile=lambda pid, path, hashes, size:
            self.index.finalize_packfile(pid, hashes))
        self.front = None
        if front is True:
            self.front = (
                TieredDedupIndex(self.index, n_shards=SHARDS, device="cpu",
                                 cold_dir=self.root / "cold",
                                 hbm_budget_bytes=BUDGET,
                                 memtable_limit=64)
                if port else
                RefTiered(mesh, self.index, cold_dir=self.root / "cold",
                          hbm_budget_bytes=BUDGET, memtable_limit=64))
        elif front is not None:
            self.front = front
        if not port:
            backend = CpuBackend(RefParams.from_desired(4096))
        elif one_pass:
            backend = GpuBackend(CDCParams.from_desired(4096), device="cpu")
        else:
            backend = PortCpuBackend(CDCParams.from_desired(4096))
        pk = packer if port else ref_packer
        self.packer = pk.DirPacker(backend, self.writer, self.index,
                                   dedup_index=self.front,
                                   on_blob=lambda h, n: None)
        if batch_bytes:
            self.packer.batch_bytes = batch_bytes
        add = self.writer.add_blob

        def recording_add(blob):
            self.added.append(bytes(blob.hash))
            add(blob)

        self.writer.add_blob = recording_add

    def pack(self, src, monkeypatch, seed=0):
        monkeypatch.setattr(packfile.os, "urandom",
                            random.Random(seed).randbytes)
        return self.packer.pack(src)

    def resolver(self, pack_dir=None):
        pf = packfile if self.port else ref_packfile
        reader = pf.PackfileReader(self.keys, pack_dir or self.root / "pack")

        def resolve(h):
            pid = self.index.lookup(h)
            if pid is None:
                raise KeyError(bytes(h).hex())
            return reader.get_blob(pid, h)

        return resolve

    def restore(self, snapshot, dest, pack_dir=None):
        up = unpacker if self.port else ref_unpacker
        up.DirUnpacker(self.resolver(pack_dir)).unpack(snapshot, dest)


def _engines(tmp_path, mesh, **kw):
    return (Engine(True, tmp_path / "port", mesh, **kw),
            Engine(False, tmp_path / "ref", mesh, **kw))


def _pack_both(engines, src, monkeypatch, seed=0):
    """Both packers over ``src``: same root, same statistics, the same
    packfiles byte for byte; returns the root."""
    port, ref = engines
    roots = [e.pack(src, monkeypatch, seed) for e in engines]
    assert roots[0] == roots[1] and len(roots[0]) == 32
    ps, rs = port.packer.stats, ref.packer.stats
    assert (ps.files, ps.failed_files, ps.dirs, ps.bytes_read, ps.chunks,
            ps.chunks_deduped, ps.bytes_deduped) == \
        (rs.files, rs.failed_files, rs.dirs, rs.bytes_read, rs.chunks,
         rs.chunks_deduped, rs.bytes_deduped)
    assert ps.dedup_divergences == rs.dedup_divergences == 0
    assert port.added == ref.added
    assert _pack_files(port.root / "pack") == _pack_files(ref.root / "pack")
    return roots[0]


def _pack_files(d):
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(Path(d).rglob("*")) if p.is_file()}


def _restore_both(engines, snapshot, tmp_path, files):
    """Each package restores the snapshot from its own packfiles and from
    the other's; every tree equals ``files``."""
    port, ref = engines
    for name, eng, pack_dir in (("pp", port, None), ("rr", ref, None),
                                ("pr", port, ref.root / "pack"),
                                ("rp", ref, port.root / "pack")):
        dest = tmp_path / f"restored_{name}"
        eng.restore(snapshot, dest, pack_dir)
        for rel, data in files.items():
            p = dest / rel
            assert p.read_bytes() == data, (name, rel)
            assert p.stat().st_mtime_ns == MTIME
    return tmp_path / "restored_pp"


def _build_corpus(root: Path, rng: random.Random):
    (root / "docs").mkdir(parents=True)
    (root / "docs" / "deep" / "deeper").mkdir(parents=True)
    (root / "empty_dir").mkdir()
    files = {
        "readme.txt": b"hello backuwup\n",
        "empty.bin": b"",
        "docs/big.bin": rng.randbytes(300_000),
        "docs/deep/deeper/nested.dat": rng.randbytes(50_000),
        "docs/dup_a.bin": b"\xabsame content" * 4000,
        "docs/dup_b.bin": b"\xabsame content" * 4000,  # dedups against a
    }
    for rel, data in files.items():
        p = root / rel
        p.write_bytes(data)
        os.utime(p, ns=(MTIME, MTIME))
    return files


def _src(tmp_path, rng):
    src = tmp_path / "src"
    src.mkdir()
    return src, _build_corpus(src, rng)


def test_pack_restore_round_trip(tmp_path, rng, mesh, monkeypatch):
    src, files = _src(tmp_path, rng)
    engines = _engines(tmp_path, mesh)
    snapshot = _pack_both(engines, src, monkeypatch)
    assert engines[0].packer.stats.files == len(files)
    dest = _restore_both(engines, snapshot, tmp_path, files)
    assert (dest / "empty_dir").is_dir()


def test_identical_content_dedups(tmp_path, rng, mesh, monkeypatch):
    src, _files = _src(tmp_path, rng)
    engines = _engines(tmp_path, mesh)
    _pack_both(engines, src, monkeypatch)
    assert engines[0].packer.stats.chunks_deduped >= 1


def test_incremental_repack_is_cheap(tmp_path, rng, mesh, monkeypatch):
    """A second backup over the persisted index (and the persisted cold
    runs) re-packs nothing and gives the same snapshot id."""
    src, _files = _src(tmp_path, rng)
    engines = _engines(tmp_path, mesh)
    snap1 = _pack_both(engines, src, monkeypatch)
    for e in engines:
        e.index.flush()
    again = []
    for e in engines:
        bi = blob_index if e.port else ref_blob_index
        index2 = bi.BlobIndex(e.keys, e.root / "index")
        index2.load()
        again.append(Engine(e.port, e.root, mesh, index=index2))
    snap2 = _pack_both(again, src, monkeypatch, seed=1)
    assert snap2 == snap1
    assert again[0].writer.bytes_written == again[1].writer.bytes_written == 0
    assert again[0].added == []


def test_change_one_file_changes_root(tmp_path, rng, mesh, monkeypatch):
    src, _files = _src(tmp_path, rng)
    engines = _engines(tmp_path, mesh)
    snap1 = _pack_both(engines, src, monkeypatch)
    (src / "readme.txt").write_bytes(b"changed!")
    snap2 = _pack_both(engines, src, monkeypatch, seed=1)
    assert snap1 != snap2


def test_tree_split_chain(tmp_path, mesh, monkeypatch):
    monkeypatch.setattr(defaults, "TREE_MAX_CHILDREN", 10)
    monkeypatch.setattr(ref_defaults, "TREE_MAX_CHILDREN", 10)
    src = tmp_path / "src"
    src.mkdir()
    files = {}
    for i in range(37):
        files[f"f{i:03d}.txt"] = f"file {i}".encode()
        (src / f"f{i:03d}.txt").write_bytes(files[f"f{i:03d}.txt"])
        os.utime(src / f"f{i:03d}.txt", ns=(MTIME, MTIME))
    engines = _engines(tmp_path, mesh)
    snapshot = _pack_both(engines, src, monkeypatch)
    root = unpacker.fetch_full_tree(engines[1].resolver(), snapshot)
    assert len(root.children) == 37
    dest = _restore_both(engines, snapshot, tmp_path, files)
    assert len(list(dest.iterdir())) == 37


def test_streaming_manifest_matches_whole_file(rng):
    backend = GpuBackend(CDCParams.from_desired(4096), device="cpu")
    data = rng.randbytes(150_000)
    whole = CpuBackend(RefParams.from_desired(4096)).manifest(data)
    emitted = []
    streamed = backend.manifest_stream(
        io.BytesIO(data).read, segment_bytes=32768,
        emit=lambda ref, chunk: emitted.append((ref.offset, chunk)))
    assert [(r.offset, r.length, r.hash) for r in streamed] == \
        [(r.offset, r.length, r.hash) for r in whole]
    assert streamed == backend.manifest(data)
    for off, chunk in emitted:
        assert data[off:off + len(chunk)] == chunk


def test_large_file_takes_streaming_path(tmp_path, rng, mesh, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    big = rng.randbytes(200_000)
    (src / "big.bin").write_bytes(big)
    os.utime(src / "big.bin", ns=(MTIME, MTIME))
    # batch_bytes below the file's size: the manifest_stream path
    engines = _engines(tmp_path, mesh, batch_bytes=50_000)
    snapshot = _pack_both(engines, src, monkeypatch)
    _restore_both(engines, snapshot, tmp_path, {"big.bin": big})
    # the same snapshot id as the batched path
    other = _engines(tmp_path / "other", mesh)
    assert _pack_both(other, src, monkeypatch) == snapshot


@pytest.mark.parametrize("one_pass", [True, False])
def test_carry_reference_front_mid_run(tmp_path, rng, mesh, monkeypatch,
                                       one_pass):
    """The reference packs a first tree with its tiered front; the port
    takes over from that state (the front through
    ``carry.tiered_from_reference``, the packfiles and cold runs copied,
    the authority loaded from the reference's index files) and both pack
    a second tree that shares most of its content: the same root,
    statistics and packfiles, and both fronts still answer duplicate for
    every blob.  On the two-pass path (the port's ``CpuBackend``, whose
    calls into the front are the reference's) the fronts also end in the
    same state, cold runs included; the one-pass path inserts each batch
    in another lane order, so its table layout, and with it the choice
    among equally old demotion victims, may differ."""
    src, files = _src(tmp_path, rng)
    ref = Engine(False, tmp_path / "ref", mesh)
    snap1 = ref.pack(src, monkeypatch)
    assert len(ref.front.cold) > 0  # the tier split is live
    ref.index.flush()
    for part in ("index", "cold", "pack"):
        shutil.copytree(tmp_path / "ref" / part, tmp_path / "port" / part)
    index = blob_index.BlobIndex(KeyManager.from_secret(SECRET),
                                 tmp_path / "port" / "index")
    assert index.load() == len(ref.index)
    front = carry.tiered_from_reference(ref.front, index,
                                        tmp_path / "port" / "cold",
                                        device="cpu")
    port = Engine(True, tmp_path / "port", mesh, front=front, index=index,
                  one_pass=one_pass)
    ref2 = Engine(False, tmp_path / "ref", mesh, front=ref.front,
                  index=ref.index)
    (src / "docs" / "new.bin").write_bytes(rng.randbytes(120_000))
    (src / "readme.txt").write_bytes(b"second backup\n")
    snap2 = _pack_both((port, ref2), src, monkeypatch, seed=1)
    assert snap2 != snap1
    # every chunk of the first tree dedups: only new blobs were written
    assert set(port.added).isdisjoint(ref.added)
    assert port.packer.stats.chunks_deduped > 0
    known = list(ref.index.blob_map())
    assert known and all(port.front.classify_insert(known))
    assert all(ref.front.classify_insert(known))
    if not one_pass:
        for f in (port.front, ref.front):
            f.cold.flush()
        assert list(port.front._recent) == list(ref.front._recent)
        assert {p.name: p.read_bytes() for p in
                sorted((tmp_path / "port" / "cold").glob("r*.run"))} == \
            {p.name: p.read_bytes() for p in
             sorted((tmp_path / "ref" / "cold").glob("r*.run"))}
