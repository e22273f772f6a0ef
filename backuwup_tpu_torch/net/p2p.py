"""P2P data plane, host storage part: what a peer does with the bytes.

Counterpart of the storage half of ``backuwup_tpu/net/p2p.py``, copied so
that the port imports nothing of the JAX package:

* :func:`obfuscate` -- hosts store received packfiles and shards
  XOR-obfuscated with a local 4-byte key, so a casual host can't read
  foreign (already encrypted) files (``received_files_writer.rs:76-78``);
* :class:`PartialStore` -- receiver-side staging of chunked transfers;
* :class:`ReceivedFilesWriter` -- a peer's packfiles, shards and index
  files, obfuscated and held to the negotiated quota with a 16 MiB grace
  (``:101-108``);
* :class:`RestoreFilesWriter` -- one's own files coming back at restore,
  shards laid out per stripe for ``erasure.stripe.assemble_tree``.

The transport (``Transport``, ``Receiver``, ``P2PNode``: signed,
replay-protected, acked frames over WebSocket) is not here: it needs
``websockets`` or ``aiohttp``, and comes with the network plane.  What a
transport hands these writers -- ``(file_info, file_id, bytes)`` -- is all
they take.
"""

from __future__ import annotations

import asyncio
import json
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from .. import defaults, wire
from ..obs import metrics as obs_metrics
from ..ops.blake3_cpu import blake3_many
from ..store import Store
from ..utils import durable, faults

_PARTIALS_EXPIRED = obs_metrics.counter(
    "bkw_partials_expired_total",
    "Abandoned partial transfers expired by the receiver-side TTL janitor")

# Crash-matrix seam around the receiver's partial-stage commit, under the
# reference's names.  ``faults.crashpoint`` fires them when armed; they are
# not registered, since the port has no crash matrix that enumerates
# ``faults.crash_sites()``, which lists the packfile, index, challenge and
# tier seams.
_CP_PARTIAL_PRE = "partial.sink.pre"
_CP_PARTIAL_POST = "partial.sink.post"


class P2PError(Exception):
    pass


def obfuscate(data: bytes, key: bytes) -> bytes:
    """XOR with a repeating 4-byte key (net_p2p/mod.rs:38-47); involutive."""
    if len(key) != 4:
        raise ValueError("obfuscation key must be 4 bytes")
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    pad = -len(arr) % 4
    if pad:
        arr = np.concatenate([arr, np.zeros(pad, np.uint8)])
    k = np.frombuffer(bytes(key) * (len(arr) // 4), dtype=np.uint8)
    out = (arr ^ k).tobytes()
    return out[:len(data)]


class PartialStore:
    """Receiver-side staging for chunked transfers (docs/transfer.md).

    One in-flight file is a ``<file_id hex>.bin`` byte prefix plus a
    ``.json`` meta record (total size, whole-file digest, file kind)
    under the writer's ``partial/`` subtree.  All methods are synchronous
    disk work — callers run them in an executor.  Invariants:

    * parts append strictly contiguously; a gap is a protocol error;
    * part 0 always truncates: a sender that restarted from zero (stale
      or corrupt partial) implicitly discards the old bytes;
    * the assembled file must match the whole-file BLAKE3 before it is
      handed to the real sink — a corrupted partial is discarded, never
      acked, never resumed.
    """

    def __init__(self, base: Path):
        self.base = Path(base)

    def _paths(self, file_id: bytes) -> Tuple[Path, Path]:
        stem = bytes(file_id).hex()
        return self.base / f"{stem}.bin", self.base / f"{stem}.json"

    def query(self, file_id: bytes) -> Tuple[int, bytes, bytes]:
        """(held bytes, whole-file digest, prefix digest) for RESUME_OFFER;
        (0, b"", b"") when nothing usable is held."""
        bin_p, meta_p = self._paths(file_id)
        if not bin_p.exists() or not meta_p.exists():
            return 0, b"", b""
        try:
            meta = json.loads(meta_p.read_text())
            digest = bytes.fromhex(meta["digest"])
            held = bin_p.read_bytes()
        except (KeyError, ValueError, OSError):
            self.discard(file_id)
            return 0, b"", b""
        if not held:
            return 0, b"", b""
        return len(held), digest, blake3_many([held])[0]

    def append(self, file_info: wire.FileInfoKind, file_id: bytes,
               offset: int, total: int, digest: bytes,
               data: bytes) -> Optional[bytes]:
        """Stage one part; returns the assembled, digest-verified bytes
        when the file completed, else None."""
        bin_p, meta_p = self._paths(file_id)
        offset, total = int(offset), int(total)
        if offset == 0:
            self.base.mkdir(parents=True, exist_ok=True)
            # tmp+replace+fsync: a crash mid-meta-write must never leave a
            # truncated .json that query() would half-trust on resume
            durable.write_replace(meta_p, json.dumps(
                {"total": total, "digest": bytes(digest).hex(),
                 "file_info": int(file_info)}, sort_keys=True).encode())
            bin_p.write_bytes(bytes(data))
        else:
            if not bin_p.exists() or not meta_p.exists():
                raise P2PError("FILE_PART continues an unknown partial")
            meta = json.loads(meta_p.read_text())
            if meta.get("digest") != bytes(digest).hex() \
                    or int(meta.get("total", -1)) != total:
                self.discard(file_id)
                raise P2PError("FILE_PART metadata mismatch;"
                               " partial discarded")
            held = bin_p.stat().st_size
            if offset != held:
                raise P2PError(f"non-contiguous FILE_PART: offset {offset},"
                               f" held {held}")
            with bin_p.open("ab") as f:
                f.write(bytes(data))
        held = bin_p.stat().st_size
        if held < total:
            return None
        raw = bin_p.read_bytes()
        if held > total or blake3_many([raw])[0] != bytes(digest):
            self.discard(file_id)
            raise P2PError("assembled file digest mismatch;"
                           " partial discarded")
        self.discard(file_id)
        return raw

    def discard(self, file_id: bytes) -> None:
        for p in self._paths(file_id):
            try:
                p.unlink()
            except OSError:
                pass

    def expire(self, ttl_s: Optional[float] = None,
               now: Optional[float] = None) -> int:
        """TTL janitor: delete abandoned partials (bin/json pairs — and
        stray meta ``.tmp`` files from a crashed writer) whose newest
        member is older than ``ttl_s``.  Returns the number of partial
        *files* (distinct ids) expired; each bumps
        ``bkw_partials_expired_total``.  A sender that never returns must
        not leak receiver quota forever."""
        ttl = defaults.PARTIAL_STORE_TTL_S if ttl_s is None else float(ttl_s)
        now = time.time() if now is None else float(now)
        if not self.base.is_dir():
            return 0
        newest: Dict[str, float] = {}
        members: Dict[str, list] = {}
        for p in self.base.iterdir():
            if not p.is_file():
                continue
            stem = p.name.split(".", 1)[0]
            try:
                mtime = p.stat().st_mtime
            except OSError:
                continue
            newest[stem] = max(newest.get(stem, 0.0), mtime)
            members.setdefault(stem, []).append(p)
        expired = 0
        for stem, latest in newest.items():
            if now - latest <= ttl:
                continue
            for p in members[stem]:
                try:
                    p.unlink()
                except OSError:
                    pass
            expired += 1
        if expired:
            _PARTIALS_EXPIRED.inc(expired)
        return expired


class _ResumableSinkMixin:
    """Chunked-transfer entry points riding on a writer's ``partials``
    (a :class:`PartialStore`) and whole-file ``sink``; wired into
    :class:`Receiver` as ``part_sink``/``resume_query``."""

    def _check_part_admission(self, file_info: wire.FileInfoKind,
                              file_id: bytes, total: int) -> None:
        """Veto hook before part 0 burns disk (quota, etc.)."""

    async def sink_part(self, file_info: wire.FileInfoKind, file_id: bytes,
                        data: bytes, offset: int, total: int,
                        digest: bytes) -> bool:
        loop = asyncio.get_running_loop()

        def stage():
            if int(offset) == 0:
                self._check_part_admission(file_info, file_id, int(total))
            faults.crashpoint(_CP_PARTIAL_PRE)
            out = self.partials.append(file_info, file_id, offset, total,
                                       digest, data)
            faults.crashpoint(_CP_PARTIAL_POST)
            return out

        raw = await loop.run_in_executor(None, stage)
        if raw is None:
            return False
        await self.sink(file_info, file_id, raw)
        return True

    async def resume_offer(self, file_info: wire.FileInfoKind,
                           file_id: bytes) -> Tuple[int, bytes, bytes]:
        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: self.partials.query(file_id))


class ReceivedFilesWriter(_ResumableSinkMixin):
    """Store a peer's packfiles/indexes, obfuscated + quota-enforced
    (received_files_writer.rs)."""

    def __init__(self, store: Store, peer_id: bytes):
        self.store = store
        self.peer_id = bytes(peer_id)
        self.dir = store.received_dir(peer_id)
        self.partials = PartialStore(self.dir / "partial")
        key = store.get_obfuscation_key()
        if key is None:
            raise P2PError("obfuscation key not initialized")
        self.key = key

    def _quota_left(self) -> int:
        peer = self.store.get_peer(self.peer_id)
        negotiated = peer.bytes_negotiated if peer else 0
        received = peer.bytes_received if peer else 0
        return negotiated - received + defaults.PEER_OVERUSE_GRACE

    def _dest(self, file_info: wire.FileInfoKind, file_id: bytes) -> Path:
        if file_info == wire.FileInfoKind.INDEX:
            sub = "index"
        elif file_info == wire.FileInfoKind.SHARD:
            sub = "shard"  # file_id is the 13-byte shard id
        else:
            sub = "pack"
        return self.dir / sub / bytes(file_id).hex()

    def _check_part_admission(self, file_info: wire.FileInfoKind,
                              file_id: bytes, total: int) -> None:
        # refuse a chunked transfer up front when the whole file could
        # never fit the quota — don't burn disk on a doomed partial
        # (idempotent re-sends of an already-stored file are exempt:
        # the final sink acks those without re-counting)
        if not self._dest(file_info, file_id).exists() \
                and total > self._quota_left():
            raise P2PError("peer exceeded negotiated storage quota")

    async def sink(self, file_info: wire.FileInfoKind, file_id: bytes,
                   data: bytes) -> None:
        path = self._dest(file_info, file_id)
        d = path.parent
        loop = asyncio.get_running_loop()

        def persist() -> bool:
            """Blocking disk work off the event loop (the prover may be
            mid-backup itself: a slow disk here must not stall its own
            transfer plane).  Returns True if the file was new."""
            d.mkdir(parents=True, exist_ok=True)
            if path.exists():
                # Idempotent re-send: if the sender's ack was lost (crash
                # or drop between our write and their receive) it will
                # retry the identical file on a fresh session.  Same id +
                # same bytes => ack without re-counting quota; anything
                # else is still the collision refusal
                # (received_files_writer.rs:54-56).  XOR obfuscation is
                # deterministic, so comparing stored bytes against the
                # re-obfuscated payload is exact.
                if path.read_bytes() == obfuscate(data, self.key):
                    return False
                raise P2PError(f"refusing to overwrite {path.name}"
                               " with different bytes")
            if len(data) > self._quota_left():
                raise P2PError("peer exceeded negotiated storage quota")
            path.write_bytes(obfuscate(data, self.key))
            return True

        if await loop.run_in_executor(None, persist):
            self.store.add_peer_received(self.peer_id, len(data))

    def iter_stored(self):
        """Yield (file_info, file_id, de-obfuscated bytes) of everything this
        peer stored with us — the restore-serving source (restore_send.rs)."""
        for sub, kind in (("pack", wire.FileInfoKind.PACKFILE),
                          ("shard", wire.FileInfoKind.SHARD),
                          ("index", wire.FileInfoKind.INDEX)):
            d = self.dir / sub
            if not d.is_dir():
                continue
            for f in sorted(d.iterdir()):
                yield kind, bytes.fromhex(f.name), obfuscate(f.read_bytes(),
                                                             self.key)


class RestoreFilesWriter(_ResumableSinkMixin):
    """Save own packfiles/shards coming back from a peer during restore
    (restore_files_writer.rs).  ``base`` overrides the destination tree —
    sourceless shard repair stages its survivor fetches in a scratch dir
    instead of the restore dir."""

    def __init__(self, store: Store, base: Optional[object] = None):
        self.dir = Path(base) if base is not None else store.restore_dir()
        self.partials = PartialStore(self.dir / "partial")
        self.files = 0

    async def sink(self, file_info: wire.FileInfoKind, file_id: bytes,
                   data: bytes) -> None:
        if file_info == wire.FileInfoKind.INDEX:
            d = self.dir / "index"
            name = f"{int.from_bytes(bytes(file_id)[:8], 'little'):06d}"
        elif file_info == wire.FileInfoKind.SHARD:
            # shard/<packfile hex>/<index>: one directory per stripe so
            # assembly (erasure/stripe.py assemble_tree) can walk it
            pid, idx = bytes(file_id)[:-1], bytes(file_id)[-1]
            d = self.dir / "shard" / pid.hex()
            name = f"{idx:03d}"
        else:
            d = self.dir / "pack" / bytes(file_id).hex()[:2]
            name = bytes(file_id).hex()
        def persist() -> None:
            d.mkdir(parents=True, exist_ok=True)
            (d / name).write_bytes(data)

        # restore pulls run one Receiver per peer concurrently; the write
        # happens off the loop so one slow disk flush never stalls the
        # other peers' frames
        await asyncio.get_running_loop().run_in_executor(None, persist)
        self.files += 1
