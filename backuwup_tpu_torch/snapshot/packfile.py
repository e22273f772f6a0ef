"""Packfile write/read: dedup -> compress -> encrypt -> pack.

Counterpart of ``backuwup_tpu/snapshot/packfile.py``: the same on-disk
format, so each package reads the other's packfiles.

Re-designs the reference packfile manager (``client/src/backup/filesystem/
packfile/mod.rs:46-64``, ``pack.rs``, ``unpack.rs``) with the same on-disk
format semantics:

    u64-LE header_ct_len || AESGCM(header) || blob section
    blob section entry:  nonce(12) || AESGCM(zstd(blob data))

* per-blob key  = HKDF(backup secret, blob_hash)   (pack.rs:66-70)
* header key    = HKDF(backup secret, b"header")   (pack.rs:206-215)
* header nonce  = the random 12-byte packfile id   (packfile/mod.rs:25,
  types.rs PackfileId doubles as nonce)
* blob nonce    = random 12 bytes per blob
* header        = sequence of PackfileHeaderBlob{hash, kind, compression,
  length, offset} in the deterministic binary codec

Write policy mirrors ``packfile/mod.rs:25-29``: flush a packfile when the
buffered plain size crosses PACKFILE_TARGET_SIZE or PACKFILE_MAX_BLOBS,
hard-capped at PACKFILE_MAX_SIZE.  Files shard into ``pack/<2 hex>/<hex>``
directories (``file_utils.rs:40-52``).

An unflushed manager going out of scope is a bug in the caller; the
reference panics in ``Drop`` (``packfile/mod.rs:86-92``), here ``close()``
raises ``DirtyPackfileError`` if data would be lost.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ModuleNotFoundError:  # containers without the wheel: libcrypto shim
    from ..utils.compat_crypto import AESGCM

from .. import defaults
from ..crypto import KeyManager
from ..obs import metrics as obs_metrics
from ..utils import durable, faults, zstd
from ..utils.serialization import Reader, Writer
from ..wire import (
    PACKFILE_ID_LEN,
    Blob,
    CompressionKind,
    PackfileHeaderBlob,
)

HEADER_KEY_INFO = b"header"
NONCE_LEN = 12

# Crash-matrix seams around the packfile seal commit (docs/crash_consistency.md)
_CP_SEAL_PRE = faults.register_crash_site("pack.seal.pre")
_CP_SEAL_POST = faults.register_crash_site("pack.seal.post")

_STAGE_SECONDS = obs_metrics.histogram(
    "bkw_pack_stage_seconds",
    "Packfile pipeline stage times (seal=zstd+AES-GCM per blob,"
    " write=assemble+fsync per packfile, stall=packer blocked on the"
    " double buffer, chunk_hash=CDC+fingerprint per stream)",
    ("stage",))


class PackfileError(Exception):
    pass


class DirtyPackfileError(PackfileError):
    """close() called with unflushed blobs (reference Drop panic analog)."""


class BlobNotFoundError(PackfileError):
    pass


def packfile_path(base: Path, packfile_id: bytes) -> Path:
    """pack/<2-hex>/<hex> sharding (file_utils.rs:40-52)."""
    hexid = bytes(packfile_id).hex()
    return Path(base) / hexid[:2] / hexid


def _compress(data: bytes) -> tuple:
    if zstd.available():
        return CompressionKind.ZSTD, zstd.compress(
            data, defaults.ZSTD_COMPRESSION_LEVEL)
    import zlib
    return CompressionKind.ZLIB, zlib.compress(
        data, defaults.ZSTD_COMPRESSION_LEVEL)


def _decompress(kind: CompressionKind, data: bytes) -> bytes:
    if kind == CompressionKind.NONE:
        return data
    if kind == CompressionKind.ZSTD:
        return zstd.decompress(data)
    if kind == CompressionKind.ZLIB:
        import zlib
        return zlib.decompress(data)
    raise PackfileError(f"unknown compression kind {kind}")


@dataclass
class _Pending:
    header: PackfileHeaderBlob
    record: bytes  # nonce || ciphertext
    plain_len: int


class PackfileWriter:
    """Accumulates encrypted blobs and writes packfiles.

    ``on_packfile(packfile_id, path, blob_hashes, size)`` fires after each
    file lands on disk — the seam the send pipeline and blob index hang off.

    With ``seal_workers=0`` (the default) every blob is compressed +
    encrypted inline in ``add_blob`` and packfiles are written
    synchronously at the thresholds — the original behavior, byte for
    byte.  With ``seal_workers > 0`` the seal work (zstd + AES-GCM, both
    release the GIL) runs on a small thread pool and packfile assembly +
    disk writes run on a single ordered writer thread, double-buffered:
    at most ``defaults.PACK_SEAL_QUEUE_PACKFILES`` batches may be in
    flight before ``add_blob`` blocks, so chunk+hash, seal, and upload
    overlap instead of summing (docs/transfer.md).  The hard size cap is
    then enforced on the writer thread against actual ciphertext sizes
    (a batch splits into several packfiles if needed); worker errors
    surface on the next ``add_blob``/``flush``.  ``on_packfile`` fires on
    the writer thread — same off-loop contract as the packer-thread
    callback in synchronous mode.
    """

    # encoded header entry: hash(32) + kind(4) + compression(4) + length(8)
    # + offset(8); file layout: len(8) + AESGCM tag(16) + count field(8)
    _HEADER_ENTRY = 56
    _FILE_OVERHEAD = 8 + 16 + 8

    def __init__(self, keys: KeyManager, out_dir: Path,
                 on_packfile: Optional[Callable] = None,
                 seal_workers: int = 0):
        self.keys = keys
        self.out_dir = Path(out_dir)
        self.on_packfile = on_packfile
        self._pending: List[_Pending] = []
        self._pending_plain = 0
        self._pending_ct = 0
        self._header_key = keys.derive_backup_key(HEADER_KEY_INFO)
        self.bytes_written = 0
        self.seal_workers = max(0, int(seal_workers or 0))
        self._seal_pool: Optional[ThreadPoolExecutor] = None
        self._write_pool: Optional[ThreadPoolExecutor] = None
        self._batch: List = []  # futures of _Pending, submission order
        self._writes: deque = deque()  # in-flight assemble+write futures
        self._stats_lock = threading.Lock()
        self.stage_seconds = {"seal": 0.0, "write": 0.0, "stall": 0.0}
        if self.seal_workers:
            self._seal_pool = ThreadPoolExecutor(
                max_workers=self.seal_workers,
                thread_name_prefix="pack-seal")
            # exactly one writer thread: packfile writes stay ordered
            self._write_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pack-write")

    def _file_size(self, n_blobs: int, ct_bytes: int) -> int:
        return self._FILE_OVERHEAD + n_blobs * self._HEADER_ENTRY + ct_bytes

    @property
    def _cap(self) -> int:
        # the binding cap is the smaller of the format cap (16 MiB,
        # packfile/mod.rs:27) and what one signed transport message can
        # carry (defaults.PACKFILE_WIRE_MAX) — a packfile that cannot be
        # sent would strand the backup
        return min(defaults.PACKFILE_MAX_SIZE, defaults.PACKFILE_WIRE_MAX)

    @property
    def pending_blobs(self) -> int:
        return len(self._pending) + len(self._batch)

    def _seal_blob(self, blob_hash: bytes, kind, data: bytes) -> _Pending:
        """compress + encrypt one blob (GIL-releasing hot path)."""
        t0 = time.monotonic()
        comp_kind, comp = _compress(data)
        key = self.keys.derive_backup_key(blob_hash)
        nonce = os.urandom(NONCE_LEN)
        ct = AESGCM(key).encrypt(nonce, comp, None)
        record = nonce + ct
        header = PackfileHeaderBlob(
            hash=blob_hash, kind=kind, compression=comp_kind,
            length=len(record), offset=0)  # offset assigned at write time
        dt = time.monotonic() - t0
        with self._stats_lock:
            self.stage_seconds["seal"] += dt
        _STAGE_SECONDS.observe(dt, stage="seal")
        return _Pending(header, record, len(data))

    def add_blob(self, blob: Blob) -> None:
        """Encrypt + queue one blob; trigger a packfile write at thresholds.

        Dedup is the caller's job (the blob index) — this layer packs what
        it is given, mirroring pack.rs:31-55's split of responsibilities.
        """
        if self.seal_workers:
            self._add_blob_pipelined(blob)
            return
        p = self._seal_blob(blob.hash, blob.kind, blob.data)
        record = p.record
        cap = self._cap
        if self._file_size(1, len(record)) > cap:
            raise PackfileError("single blob exceeds packfile max size")
        # hard cap is enforced *before* anything hits disk: flush the current
        # batch if this blob would push the file over the cap
        if self._pending and (
                self._file_size(len(self._pending) + 1,
                                self._pending_ct + len(record))
                > cap):
            self._write_packfile()
        self._pending.append(p)
        self._pending_plain += len(blob.data)
        self._pending_ct += len(record)
        if (self._pending_plain >= defaults.PACKFILE_TARGET_SIZE
                or len(self._pending) >= defaults.PACKFILE_MAX_BLOBS):
            self._write_packfile()

    # --- pipelined seal path (seal_workers > 0) ----------------------------

    def _add_blob_pipelined(self, blob: Blob) -> None:
        self._batch.append(self._seal_pool.submit(
            self._seal_blob, blob.hash, blob.kind, blob.data))
        self._pending_plain += len(blob.data)
        if (self._pending_plain >= defaults.PACKFILE_TARGET_SIZE
                or len(self._batch) >= defaults.PACKFILE_MAX_BLOBS):
            self._submit_batch()

    def _submit_batch(self) -> None:
        batch, self._batch = self._batch, []
        self._pending_plain = 0
        # double buffering: at most PACK_SEAL_QUEUE_PACKFILES batches may
        # be sealing/writing; beyond that the packer thread stalls here
        # (and surfaces any earlier writer-thread error)
        t0 = time.monotonic()
        while len(self._writes) >= max(1, defaults.PACK_SEAL_QUEUE_PACKFILES):
            self._writes.popleft().result()
        dt = time.monotonic() - t0
        with self._stats_lock:
            self.stage_seconds["stall"] += dt
        _STAGE_SECONDS.observe(dt, stage="stall")
        self._writes.append(self._write_pool.submit(
            self._assemble_batch, batch))

    def _assemble_batch(self, batch: List) -> None:
        """Writer thread: wait for the batch's seals, split on the hard
        cap against actual ciphertext sizes, and write each group."""
        pendings = [f.result() for f in batch]
        cap = self._cap
        group: List[_Pending] = []
        ct = 0
        for p in pendings:
            if self._file_size(1, len(p.record)) > cap:
                raise PackfileError("single blob exceeds packfile max size")
            if group and (self._file_size(len(group) + 1,
                                          ct + len(p.record)) > cap):
                self._write_group(group)
                group, ct = [], 0
            group.append(p)
            ct += len(p.record)
        if group:
            self._write_group(group)

    def emit_partial(self) -> None:
        """Hand whatever is buffered below the target size to the seal
        pipeline NOW (the packer's lag bound, docs/dataflow.md), without
        draining in-flight writes like :meth:`flush` does.  Packfile
        boundaries move, bytes do not — the snapshot id is
        content-addressed and independent of how blobs group into
        packfiles, so partial emission never changes the snapshot."""
        if self.seal_workers:
            if self._batch:
                self._submit_batch()
            return
        if self._pending:
            self._write_packfile()

    def flush(self) -> None:
        if self.seal_workers:
            if self._batch:
                self._submit_batch()
            while self._writes:
                self._writes.popleft().result()
            return
        if self._pending:
            self._write_packfile()

    def close(self) -> None:
        if self._pending or self._batch:
            raise DirtyPackfileError(
                f"{len(self._pending) + len(self._batch)} unflushed blobs"
                " — call flush()")
        self.shutdown()

    def shutdown(self) -> None:
        """Tear down the seal/writer pools without the dirty check (for
        ``finally`` blocks where flush may already have raised)."""
        if self._seal_pool is not None:
            self._seal_pool.shutdown(wait=True)
        if self._write_pool is not None:
            self._write_pool.shutdown(wait=True)

    def _write_packfile(self) -> None:
        self._write_group(self._pending)
        self._pending = []
        self._pending_plain = 0
        self._pending_ct = 0

    def _write_group(self, pendings: List[_Pending]) -> None:
        t0 = time.monotonic()
        packfile_id = os.urandom(PACKFILE_ID_LEN)
        offset = 0
        headers = []
        for p in pendings:
            headers.append(PackfileHeaderBlob(
                hash=p.header.hash, kind=p.header.kind,
                compression=p.header.compression, length=p.header.length,
                offset=offset))
            offset += len(p.record)
        w = Writer()
        w.u64(len(headers))
        for h in headers:
            h.encode(w)
        header_ct = AESGCM(self._header_key).encrypt(packfile_id, w.take(), None)
        path = packfile_path(self.out_dir, packfile_id)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            f.write(len(header_ct).to_bytes(8, "little"))
            f.write(header_ct)
            for p in pendings:
                f.write(p.record)
        faults.crashpoint(_CP_SEAL_PRE)
        durable.commit_replace(tmp, path)
        faults.crashpoint(_CP_SEAL_POST)
        size = path.stat().st_size
        dt = time.monotonic() - t0
        with self._stats_lock:
            self.bytes_written += size
            self.stage_seconds["write"] += dt
        _STAGE_SECONDS.observe(dt, stage="write")
        hashes = [h.hash for h in headers]
        assert size <= self._cap, "cap enforced before write"
        if self.on_packfile is not None:
            self.on_packfile(packfile_id, path, hashes, size)


class PackfileReader:
    """Random access to blobs in a directory of packfiles (unpack.rs:23-83)."""

    def __init__(self, keys: KeyManager, base_dir: Path):
        self.keys = keys
        self.base_dir = Path(base_dir)
        self._header_key = keys.derive_backup_key(HEADER_KEY_INFO)
        self._header_cache: Dict[bytes, list] = {}

    def read_header(self, packfile_id: bytes) -> list:
        pid = bytes(packfile_id)
        if pid in self._header_cache:
            return self._header_cache[pid]
        path = packfile_path(self.base_dir, pid)
        with open(path, "rb") as f:
            hlen = int.from_bytes(f.read(8), "little")
            header_ct = f.read(hlen)
        plain = AESGCM(self._header_key).decrypt(pid, header_ct, None)
        r = Reader(plain)
        entries = [PackfileHeaderBlob.decode(r) for _ in range(r.u64())]
        r.expect_end()
        self._header_cache[pid] = entries
        return entries

    def get_blob(self, packfile_id: bytes, blob_hash: bytes) -> Blob:
        entries = self.read_header(packfile_id)
        entry = next((e for e in entries if e.hash == bytes(blob_hash)), None)
        if entry is None:
            raise BlobNotFoundError(bytes(blob_hash).hex())
        path = packfile_path(self.base_dir, packfile_id)
        with open(path, "rb") as f:
            hlen = int.from_bytes(f.read(8), "little")
            f.seek(8 + hlen + entry.offset)
            record = f.read(entry.length)
        nonce, ct = record[:NONCE_LEN], record[NONCE_LEN:]
        key = self.keys.derive_backup_key(entry.hash)
        data = _decompress(entry.compression, AESGCM(key).decrypt(nonce, ct, None))
        return Blob(hash=entry.hash, kind=entry.kind, data=data)

    def iter_blobs(self, packfile_id: bytes):
        """All blobs of one packfile: one open, one sequential pass."""
        entries = self.read_header(packfile_id)
        path = packfile_path(self.base_dir, packfile_id)
        with open(path, "rb") as f:
            hlen = int.from_bytes(f.read(8), "little")
            base = 8 + hlen
            for entry in sorted(entries, key=lambda e: e.offset):
                f.seek(base + entry.offset)
                record = f.read(entry.length)
                nonce, ct = record[:NONCE_LEN], record[NONCE_LEN:]
                key = self.keys.derive_backup_key(entry.hash)
                data = _decompress(entry.compression,
                                   AESGCM(key).decrypt(nonce, ct, None))
                yield Blob(hash=entry.hash, kind=entry.kind, data=data)
