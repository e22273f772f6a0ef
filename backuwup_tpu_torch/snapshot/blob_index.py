"""Blob index: the client-side dedup authority (blob hash -> packfile).

Counterpart of ``backuwup_tpu/snapshot/blob_index.py``: the same index and
challenge-table files, so each package reads the other's.

Re-designs ``client/src/backup/filesystem/packfile/blob_index.rs``:

* In memory: hash -> packfile-id map plus a ``queued`` set for blobs that
  are encrypted-and-buffered but not yet inside a written packfile
  (``blob_index.rs:52-53,130-140``) — both consulted for dedup.
* On disk: sequentially numbered encrypted files of at most
  ``INDEX_FILE_MAX_ENTRIES`` entries (``blob_index.rs:16-19``); file key =
  HKDF(backup secret, b"index"), nonce = the 12-byte little-endian file
  counter (``blob_index.rs:183-237``), so index files are tamper-evident
  and positionally bound.
* The index is a cache: it can always be rebuilt from packfile headers
  (``blob_index.rs:23-43``) — :meth:`BlobIndex.rebuild_from_packfiles`.

This in-memory map is the authority of the dedup lookup; the device
table (:mod:`backuwup_tpu_torch.ops.dedup_index`, behind the tiered front)
accelerates the same contract for huge indexes.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ModuleNotFoundError:  # containers without the wheel: libcrypto shim
    from ..utils.compat_crypto import AESGCM

from .. import defaults
from ..crypto import KeyManager
from ..utils import durable, faults
from ..utils.serialization import Reader, Writer
from ..wire import AUDIT_NONCE_LEN, BLOB_HASH_LEN, PACKFILE_ID_LEN

INDEX_KEY_INFO = b"index"
CHALLENGE_KEY_INFO = b"audit"
_NAME_RE = re.compile(r"^\d{6}$")

#: Deletion record inside index files (docs/lifecycle.md).  GC flushes a
#: (hash, TOMBSTONE_PID) entry for every blob it dropped; with the
#: later-files-win load order that kills the mapping on reload (and on a
#: restored index), so a dead blob can never dedup a future backup
#: against a packfile that no longer exists.  Real packfile ids are 12
#: random bytes, so the all-zero id is free to act as the sentinel.
TOMBSTONE_PID = b"\x00" * PACKFILE_ID_LEN

# Crash-matrix seams: the window either side of each durable commit.
_CP_CHALLENGE_PRE = faults.register_crash_site("challenge.save.pre")
_CP_CHALLENGE_POST = faults.register_crash_site("challenge.save.post")
_CP_INDEX_PRE = faults.register_crash_site("index.save.pre")
_CP_INDEX_POST = faults.register_crash_site("index.save.post")


def index_file_name(counter: int) -> str:
    """Zero-padded numbering (file_utils.rs:55-57)."""
    return f"{counter:06d}"


@dataclass(frozen=True)
class ChallengeEntry:
    """One precomputed audit probe: expected digest of a sampled window.

    ``digest = blake3(nonce || packfile_bytes[offset : offset+length])`` —
    the verifier records it at pack time (while the plaintext packfile is
    still on disk) because the local copy is deleted once a peer acks it.
    """

    offset: int
    length: int
    nonce: bytes  # AUDIT_NONCE_LEN; keys the digest so peers can't precompute
    digest: bytes  # BLOB_HASH_LEN


class ChallengeTable:
    """Write-once encrypted audit challenge tables, one file per packfile.

    Same persistence idiom as the blob index: AES-GCM with a positionally
    bound nonce — here the 12-byte packfile id itself, which is unique per
    table, and the file is never rewritten, so the (key, nonce) pair
    encrypts exactly one plaintext.  Key = HKDF(backup secret, b"audit"),
    distinct from the index key so audit state and dedup state are
    cryptographically separated.
    """

    def __init__(self, keys: KeyManager, table_dir: Path):
        self.table_dir = Path(table_dir)
        self._key = keys.derive_backup_key(CHALLENGE_KEY_INFO)

    def path(self, packfile_id: bytes) -> Path:
        return self.table_dir / bytes(packfile_id).hex()

    def has(self, packfile_id: bytes) -> bool:
        return self.path(packfile_id).is_file()

    def save(self, packfile_id: bytes,
             entries: Iterable[ChallengeEntry]) -> Path:
        # id is a 12-byte packfile id or a 13-byte shard id (packfile id +
        # index byte, erasure/stripe.py); both are unique and both work as
        # the GCM nonce (lengths != 12 go through EVP_CTRL_GCM_SET_IVLEN)
        pid = bytes(packfile_id)
        if len(pid) not in (PACKFILE_ID_LEN, PACKFILE_ID_LEN + 1):
            raise ValueError("bad packfile/shard id length")
        path = self.path(pid)
        if path.exists():
            raise FileExistsError(
                f"challenge table for {pid.hex()} already written"
                " (tables are write-once; rewriting would reuse the nonce)")
        entries = list(entries)
        w = Writer()
        w.u64(len(entries))
        for e in entries:
            w.u64(e.offset)
            w.u64(e.length)
            w.fixed(bytes(e.nonce))
            w.fixed(bytes(e.digest))
        ct = AESGCM(self._key).encrypt(pid, w.take(), None)
        self.table_dir.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(ct)
        faults.crashpoint(_CP_CHALLENGE_PRE)
        durable.commit_replace(tmp, path)
        faults.crashpoint(_CP_CHALLENGE_POST)
        return path

    def forget(self, packfile_ids: Iterable[bytes]) -> int:
        """Delete the table files of dead packfiles — BOTH the whole-file
        table (12-byte id) and every per-shard table (13-byte id = the
        packfile id plus one index byte, so its hex name extends the
        packfile's).  Callers of ``BlobIndex.forget_packfiles`` pair it
        with this so audit state cannot resurrect a dead packfile;
        returns files removed.  Unlike ``save``, deletion is idempotent:
        re-running after a crash just finds nothing left to remove."""
        removed = 0
        if not self.table_dir.is_dir():
            return removed
        for pid in packfile_ids:
            prefix = bytes(pid).hex()
            for path in self.table_dir.glob(f"{prefix}*"):
                try:
                    path.unlink()
                    removed += 1
                except OSError:
                    pass
        return removed

    def load(self, packfile_id: bytes) -> List[ChallengeEntry]:
        pid = bytes(packfile_id)
        plain = AESGCM(self._key).decrypt(
            pid, self.path(pid).read_bytes(), None)
        r = Reader(plain)
        out = []
        for _ in range(r.u64()):
            offset = r.u64()
            length = r.u64()
            nonce = r.fixed(AUDIT_NONCE_LEN)
            digest = r.fixed(BLOB_HASH_LEN)
            out.append(ChallengeEntry(offset, length, nonce, digest))
        r.expect_end()
        return out


class BlobIndex:
    def __init__(self, keys: KeyManager, index_dir: Path):
        self.index_dir = Path(index_dir)
        self._key = keys.derive_backup_key(INDEX_KEY_INFO)
        self._map: Dict[bytes, bytes] = {}
        self._queued: Set[bytes] = set()
        self._unsaved: List[tuple] = []
        # Never reuse a file counter: the counter is the AES-GCM nonce, and a
        # (key, nonce) pair must encrypt exactly one plaintext.  Scan the
        # directory up front so even recovery paths that skip load() (e.g.
        # rebuild_from_packfiles after a corrupt file) keep counters fresh.
        self._next_file = self._scan_next_file()

    def _scan_next_file(self) -> int:
        if not self.index_dir.is_dir():
            return 0
        # a crashed flush leaves NNNNNN.tmp behind: that counter's nonce
        # already encrypted one plaintext, so it is burned either way
        numbers = [int(p.name.split(".")[0]) for p in self.index_dir.iterdir()
                   if _NAME_RE.match(p.name.split(".")[0])]
        return max(numbers) + 1 if numbers else 0

    # --- dedup contract (blob_index.rs:130-148) ----------------------------

    def is_duplicate(self, blob_hash: bytes) -> bool:
        h = bytes(blob_hash)
        return h in self._map or h in self._queued

    def mark_queued(self, blob_hash: bytes) -> None:
        self._queued.add(bytes(blob_hash))

    def finalize_packfile(self, packfile_id: bytes,
                          blob_hashes: Iterable[bytes]) -> None:
        """Blobs of a just-written packfile become committed entries."""
        pid = bytes(packfile_id)
        for h in blob_hashes:
            h = bytes(h)
            self._queued.discard(h)
            if h not in self._map:
                self._map[h] = pid
                self._unsaved.append((h, pid))

    def lookup(self, blob_hash: bytes) -> Optional[bytes]:
        return self._map.get(bytes(blob_hash))

    def hashes_for_packfiles(self, packfile_ids: Iterable[bytes]) -> Set[bytes]:
        """Committed blob hashes living in any of ``packfile_ids`` — the
        finalize_packfile bookkeeping read backwards (lost packfile ->
        which blobs must be re-packed)."""
        targets = {bytes(p) for p in packfile_ids}
        return {h for h, pid in self._map.items() if pid in targets}

    def forget_packfiles(self, packfile_ids: Iterable[bytes]) -> Set[bytes]:
        """Drop every committed entry that maps into ``packfile_ids``.

        The repair path calls this for packfiles whose only replicas were
        on a lost peer: once forgotten, ``is_duplicate`` answers False for
        exactly those blobs, so a re-pack over the unchanged source
        re-creates them (CDC + blake3 are deterministic) while every other
        blob still dedups away.  Returns the forgotten hashes.
        """
        targets = {bytes(p) for p in packfile_ids}
        lost = {h for h, pid in self._map.items() if pid in targets}
        for h in lost:
            del self._map[h]
        self._unsaved = [(h, pid) for h, pid in self._unsaved
                         if pid not in targets]
        return lost

    def record_tombstones(self, blob_hashes: Iterable[bytes]) -> int:
        """Queue deletion records for dropped blobs (GC's swap step).

        Unlike :meth:`forget_packfiles` — which only edits memory, on the
        promise that the blobs are immediately re-packed — a tombstone is
        flushed into the index files themselves, so the deletion survives
        reload and restore.  Returns tombstones queued."""
        n = 0
        for h in blob_hashes:
            h = bytes(h)
            self._map.pop(h, None)
            self._queued.discard(h)
            self._unsaved.append((h, TOMBSTONE_PID))
            n += 1
        return n

    def blob_map(self) -> Dict[bytes, bytes]:
        """Committed hash -> packfile-id snapshot — GC's mark phase joins
        this against the retained-snapshot manifests."""
        return dict(self._map)

    def packfile_ids(self) -> Set[bytes]:
        return set(self._map.values())

    def known_hashes(self) -> List[bytes]:
        """Every hash the index answers is_duplicate=True for (committed and
        queued) — the seed set for the device-resident dedup table."""
        return list(self._map.keys() | self._queued)

    @property
    def queued_count(self) -> int:
        return len(self._queued)

    def __len__(self) -> int:
        return len(self._map)

    @property
    def unsaved_entries(self) -> int:
        return len(self._unsaved)

    # --- encrypted split persistence (blob_index.rs:183-237) ---------------

    def _nonce(self, counter: int) -> bytes:
        return counter.to_bytes(PACKFILE_ID_LEN, "little")

    def flush(self) -> List[Path]:
        """Write unsaved entries into new numbered files (<=50k each).

        Returns the paths written — the send pipeline watermarks these by
        number (``config/backup.rs:80-98``).
        """
        self.index_dir.mkdir(parents=True, exist_ok=True)
        written = []
        cap = defaults.INDEX_FILE_MAX_ENTRIES
        while self._unsaved:
            batch, self._unsaved = self._unsaved[:cap], self._unsaved[cap:]
            w = Writer()
            w.u64(len(batch))
            for h, pid in batch:
                w.fixed(h)
                w.fixed(pid)
            ct = AESGCM(self._key).encrypt(self._nonce(self._next_file),
                                           w.take(), None)
            path = self.index_dir / index_file_name(self._next_file)
            tmp = path.with_suffix(".tmp")
            tmp.write_bytes(ct)
            faults.crashpoint(_CP_INDEX_PRE)
            durable.commit_replace(tmp, path)
            faults.crashpoint(_CP_INDEX_POST)
            written.append(path)
            self._next_file += 1
        return written

    def load(self) -> int:
        """Read every index file in numeric order; returns entry count.

        Later files WIN on duplicate hashes: a repair round re-homes blobs
        whose packfile died with a peer and flushes the new mapping into a
        new (higher-numbered) index file, so after a reload — or a restore
        that pulls every index file back — the hash must resolve to the
        replacement packfile, not the retired one still named by the
        original file.
        """
        if not self.index_dir.is_dir():
            return 0
        files = sorted(p for p in self.index_dir.iterdir()
                       if _NAME_RE.match(p.name))
        for path in files:
            counter = int(path.name)
            plain = AESGCM(self._key).decrypt(self._nonce(counter),
                                              path.read_bytes(), None)
            r = Reader(plain)
            for _ in range(r.u64()):
                h = r.fixed(BLOB_HASH_LEN)
                pid = r.fixed(PACKFILE_ID_LEN)
                if pid == TOMBSTONE_PID:
                    self._map.pop(h, None)
                else:
                    self._map[h] = pid
            r.expect_end()
            self._next_file = max(self._next_file, counter + 1)
        return len(self._map)

    def rebuild_from_packfiles(self, reader, pack_dir: Path) -> int:
        """Reconstruct the map from packfile headers (blob_index.rs:23-43).

        ``reader`` is a :class:`~backuwup_tpu_torch.snapshot.packfile.PackfileReader`
        over ``pack_dir``.
        """
        pack_dir = Path(pack_dir)
        if not pack_dir.is_dir():
            return 0
        for shard in sorted(pack_dir.iterdir()):
            if not shard.is_dir():
                continue
            for f in sorted(shard.iterdir()):
                try:
                    pid = bytes.fromhex(f.name)
                except ValueError:
                    continue
                if len(pid) != PACKFILE_ID_LEN:
                    continue
                for entry in reader.read_header(pid):
                    self._map.setdefault(entry.hash, pid)
        return len(self._map)
