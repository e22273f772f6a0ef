"""The port's packfiles and blob index vs the JAX package's: the cases of
``tests/test_packfile.py``, each run through both packages.

Blob nonces and packfile ids come from ``os.urandom``
(``snapshot/packfile.py``).  Each package writes under ``os.urandom``
patched onto a seeded source, started afresh with the same seed, so the
packfile bytes must be identical.  Index files are deterministic already
(their nonce is the file counter).  Each package reads the other's
packfiles and index files.  Blob hashes are BLAKE3 from the port's numpy
oracle (``blake3_many``), which equals ``blake3_hash`` and is faster.
"""

import random

import pytest

from backuwup_tpu import defaults as ref_defaults
from backuwup_tpu.crypto import KeyManager as RefKeyManager
from backuwup_tpu.snapshot import blob_index as ref_blob_index
from backuwup_tpu.snapshot import packfile as ref_packfile
from backuwup_tpu import wire as ref_wire
from backuwup_tpu_torch import defaults, wire
from backuwup_tpu_torch.crypto import KeyManager
from backuwup_tpu_torch.ops.blake3_cpu import blake3_many
from backuwup_tpu_torch.snapshot import blob_index, packfile

SECRET = bytes(range(32))
# (package name, KeyManager, packfile module, blob_index module, wire)
PORT = ("port", KeyManager, packfile, blob_index, wire)
REF = ("ref", RefKeyManager, ref_packfile, ref_blob_index, ref_wire)
PID = bytes(range(100, 112))


def _urandom(monkeypatch, seed):
    rng = random.Random(seed)
    monkeypatch.setattr(packfile.os, "urandom", rng.randbytes)


def _blobs(datas, kinds=None):
    hashes = blake3_many(datas)
    kinds = kinds or ["FILE_CHUNK"] * len(datas)
    return list(zip(hashes, kinds, datas))


def _write(pkg, out_dir, blobs, monkeypatch, seed=0, flush=True):
    """Write ``blobs`` with ``pkg``'s writer under the seeded urandom;
    returns (writer, on_packfile records)."""
    name, keys, pf, _bi, w = pkg
    _urandom(monkeypatch, seed)
    written = []
    writer = pf.PackfileWriter(
        keys.from_secret(SECRET), out_dir,
        on_packfile=lambda pid, path, hashes, size:
        written.append((pid, path, hashes, size)))
    for h, kind, data in blobs:
        writer.add_blob(w.Blob(hash=h, kind=getattr(w.BlobKind, kind),
                               data=data))
    if flush:
        writer.flush()
    return writer, written


def _write_both(tmp_path, blobs, monkeypatch, seed=0):
    """Both packages write the same blobs; their packfiles must be
    byte-identical.  Returns the (port, ref) on_packfile records."""
    out = []
    for pkg in (PORT, REF):
        writer, written = _write(pkg, tmp_path / f"pack_{pkg[0]}", blobs,
                                 monkeypatch, seed)
        writer.close()
        out.append(written)
    port, ref = out
    assert [(p, h, s) for p, _, h, s in port] == \
        [(p, h, s) for p, _, h, s in ref]
    for (_, pa, _, _), (_, pb, _, _) in zip(port, ref):
        assert pa.relative_to(tmp_path / "pack_port") == \
            pb.relative_to(tmp_path / "pack_ref")
        assert pa.read_bytes() == pb.read_bytes()
    return port, ref


def _readers(tmp_path, which):
    """Each package's reader over ``pack_<which>``."""
    return [pkg[2].PackfileReader(pkg[1].from_secret(SECRET),
                                  tmp_path / f"pack_{which}")
            for pkg in (PORT, REF)]


def test_round_trip_single_packfile(tmp_path, nprng, monkeypatch):
    datas = [nprng.integers(0, 256, n, dtype="u1").tobytes()
             for n in (10, 1000, 65536)] + [b"tree bytes"]
    blobs = _blobs(datas, ["FILE_CHUNK"] * 3 + ["TREE"])
    port, _ref = _write_both(tmp_path, blobs, monkeypatch)
    assert len(port) == 1
    pid, path, hashes, size = port[0]
    assert path == packfile.packfile_path(tmp_path / "pack_port", pid)
    assert hashes == [h for h, _, _ in blobs]
    for which in ("port", "ref"):
        for reader in _readers(tmp_path, which):
            for h, kind, data in blobs:
                got = reader.get_blob(pid, h)
                assert got.data == data and got.kind.name == kind
    with pytest.raises(packfile.BlobNotFoundError):
        _readers(tmp_path, "ref")[0].get_blob(pid, b"\x00" * 32)


def test_write_triggers_at_target_size(tmp_path, nprng, monkeypatch):
    blobs = _blobs([nprng.integers(0, 256, 1 << 20, dtype="u1").tobytes()
                    for _ in range(7)])
    for pkg in (PORT, REF):
        _writer, written = _write(pkg, tmp_path / f"pack_{pkg[0]}",
                                  blobs, monkeypatch, flush=False)
        assert len(written) >= 2  # 3 MiB target -> several files
    port, ref = _write_both(tmp_path / "flushed", blobs, monkeypatch)
    for _, path, _, size in port:
        assert size <= defaults.PACKFILE_MAX_SIZE


def test_dirty_close_raises(tmp_path, monkeypatch):
    for pkg in (PORT, REF):
        writer, _ = _write(pkg, tmp_path / pkg[0], _blobs([b"data"]),
                           monkeypatch, flush=False)
        with pytest.raises(pkg[2].DirtyPackfileError):
            writer.close()
        writer.flush()
        writer.close()


def test_encrypted_at_rest(tmp_path, monkeypatch):
    secret = b"super secret plaintext payload" * 10
    port, _ref = _write_both(tmp_path, _blobs([secret]), monkeypatch)
    assert secret not in port[0][1].read_bytes()
    for pkg in (PORT, REF):
        other = pkg[2].PackfileReader(pkg[1].from_secret(b"\x09" * 32),
                                      tmp_path / "pack_ref")
        with pytest.raises(Exception):
            other.get_blob(port[0][0], port[0][2][0])


def _index_files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_blob_index_dedup_and_persistence(tmp_path):
    h1, h2 = blake3_many([b"one", b"two"])
    for pkg in (PORT, REF):
        idx = pkg[3].BlobIndex(pkg[1].from_secret(SECRET),
                               tmp_path / f"index_{pkg[0]}")
        assert not idx.is_duplicate(h1)
        idx.mark_queued(h1)
        assert idx.is_duplicate(h1)  # queued counts as duplicate
        idx.finalize_packfile(PID, [h1, h2])
        assert idx.lookup(h2) == PID
        assert len(idx.flush()) == 1
    assert _index_files(tmp_path / "index_port") == \
        _index_files(tmp_path / "index_ref")
    # each package loads the other's index files
    for pkg, other in ((PORT, "ref"), (REF, "port")):
        idx2 = pkg[3].BlobIndex(pkg[1].from_secret(SECRET),
                                tmp_path / f"index_{other}")
        assert idx2.load() == 2
        assert idx2.lookup(h1) == PID
        assert idx2.is_duplicate(h2)
        bad = pkg[3].BlobIndex(pkg[1].from_secret(b"\x08" * 32),
                               tmp_path / f"index_{other}")
        with pytest.raises(Exception):
            bad.load()


def test_blob_index_split_files(tmp_path, monkeypatch):
    monkeypatch.setattr(defaults, "INDEX_FILE_MAX_ENTRIES", 3)
    monkeypatch.setattr(ref_defaults, "INDEX_FILE_MAX_ENTRIES", 3)
    hashes = blake3_many([bytes([i]) for i in range(8)])
    for pkg in (PORT, REF):
        idx = pkg[3].BlobIndex(pkg[1].from_secret(SECRET),
                               tmp_path / f"index_{pkg[0]}")
        idx.finalize_packfile(PID, hashes)
        files = idx.flush()
        assert [f.name for f in files] == ["000000", "000001", "000002"]
    assert _index_files(tmp_path / "index_port") == \
        _index_files(tmp_path / "index_ref")
    for pkg, other in ((PORT, "ref"), (REF, "port")):
        idx2 = pkg[3].BlobIndex(pkg[1].from_secret(SECRET),
                                tmp_path / f"index_{other}")
        assert idx2.load() == 8


def test_rebuild_from_packfiles(tmp_path, nprng, monkeypatch):
    blobs = _blobs([nprng.integers(0, 256, 500, dtype="u1").tobytes()
                    for _ in range(5)])
    _write_both(tmp_path, blobs, monkeypatch)
    for which in ("port", "ref"):
        for pkg, reader in zip((PORT, REF), _readers(tmp_path, which)):
            idx = pkg[3].BlobIndex(pkg[1].from_secret(SECRET),
                                   tmp_path / f"index_{pkg[0]}_{which}")
            assert idx.rebuild_from_packfiles(
                reader, tmp_path / f"pack_{which}") == 5
            for h, _, data in blobs:
                assert idx.is_duplicate(h)
                assert reader.get_blob(idx.lookup(h), h).data == data


def test_index_never_reuses_file_counters(tmp_path):
    """The counter doubles as the AES-GCM nonce: recovery paths that skip
    load() must still advance past existing files."""
    hx, hy = blake3_many([b"x", b"y"])
    for pkg in (PORT, REF):
        d = tmp_path / f"index_{pkg[0]}"
        idx = pkg[3].BlobIndex(pkg[1].from_secret(SECRET), d)
        idx.finalize_packfile(PID, [hx])
        first = idx.flush()[0]
        original = first.read_bytes()
        idx2 = pkg[3].BlobIndex(pkg[1].from_secret(SECRET), d)
        idx2.finalize_packfile(PID, [hy])
        files = idx2.flush()
        assert files[0].name == "000001"  # not 000000 again
        assert first.read_bytes() == original
    assert _index_files(tmp_path / "index_port") == \
        _index_files(tmp_path / "index_ref")


def test_hard_cap_enforced_before_write(tmp_path, nprng, monkeypatch):
    """A near-max blob after buffered data must flush first, never produce
    an oversized file; a blob that fits no sendable packfile is refused."""
    cap = min(defaults.PACKFILE_MAX_SIZE, defaults.PACKFILE_WIRE_MAX)
    assert cap == min(ref_defaults.PACKFILE_MAX_SIZE,
                      ref_defaults.PACKFILE_WIRE_MAX)
    blobs = _blobs([nprng.integers(0, 256, 2 << 20, dtype="u1").tobytes(),
                    nprng.integers(0, 256, 7 << 20, dtype="u1").tobytes()])
    port, _ref = _write_both(tmp_path, blobs, monkeypatch)
    assert len(port) >= 2
    for _, _, _, size in port:
        assert size <= cap
    huge = _blobs([nprng.integers(0, 256, 9 << 20, dtype="u1").tobytes()])
    for pkg in (PORT, REF):
        with pytest.raises(Exception):
            _write(pkg, tmp_path / f"huge_{pkg[0]}", huge, monkeypatch)


def test_tampered_packfile_is_rejected(tmp_path, nprng, monkeypatch):
    """Flipping ciphertext bits anywhere in a packfile must surface as a
    loud decryption failure in either package's reader."""
    data = nprng.integers(0, 256, 50_000, dtype="u1").tobytes()
    blobs = _blobs([data])
    port, _ref = _write_both(tmp_path, blobs, monkeypatch)
    (pid, path, hashes, size) = port[0]
    raw = bytearray(path.read_bytes())
    for reader in _readers(tmp_path, "port"):
        assert reader.get_blob(pid, hashes[0]).data == data
    for flip_at in (0, 5, 12, len(raw) // 2, len(raw) - 3):
        tampered = bytearray(raw)
        tampered[flip_at] ^= 0x01
        path.write_bytes(bytes(tampered))
        for reader in _readers(tmp_path, "port"):
            with pytest.raises(Exception):
                reader.get_blob(pid, hashes[0])
    path.write_bytes(bytes(raw))
    for reader in _readers(tmp_path, "port"):
        assert reader.get_blob(pid, hashes[0]).data == data
