"""Directory packer: filesystem tree -> content-addressed snapshot.

Counterpart of ``backuwup_tpu/snapshot/packer.py``: over the port's
:class:`~backuwup_tpu_torch.ops.backend.GpuBackend` the chunk batches run
on the card, and with a device dedup front (``dedup_index``, e.g. the
tiered front) their fingerprints are classified there too.  The snapshot
id and the packfile stream are the reference packer's, byte for byte.

Re-designs ``client/src/backup/filesystem/dir_packer.rs``:

* Deepest-first directory walk (``browse_dir_tree``, ``dir_packer.rs:89-132``)
  so every child tree hash exists before its parent is built.
* Files are chunked + fingerprinted through a :class:`ChunkerBackend`
  (CPU oracle or the CUDA kernels) — the batched analog of the reference's
  per-file FastCDC/blake3 hot loop (``:246-311``).  All files of one
  directory form one device batch.
* Tree nodes (``Tree`` wire blobs) carry name, metadata, and child hashes;
  nodes with more than TREE_MAX_CHILDREN children split into a
  ``next_sibling`` chain (``dir_packer.rs:35,313-363``), built back-to-front
  so each page embeds the following page's hash.
* The root tree's blob hash is the snapshot id (``dir_packer.rs:47-84``).
* Dedup: every blob (chunk or tree) is checked against the blob index
  before packing (``pack.rs:31-55``); duplicate data costs one hash lookup.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

from .. import defaults
from ..obs import metrics as obs_metrics
from ..obs import profile as obs_profile
from ..ops.backend import ChunkerBackend
from ..ops.blake3_cpu import blake3_hash
from ..utils import tracing
from ..wire import Blob, BlobKind, Tree, TreeKind, TreeMetadata
from .blob_index import BlobIndex
from .packfile import PackfileWriter

_STAGE_SECONDS = obs_metrics.histogram(
    "bkw_pack_stage_seconds", "", ("stage",))  # declared in packfile.py


@dataclass
class PackStats:
    files: int = 0
    failed_files: int = 0
    dirs: int = 0
    bytes_read: int = 0
    chunks: int = 0
    chunks_deduped: int = 0
    bytes_deduped: int = 0
    dedup_divergences: int = 0
    # wall seconds inside the chunk+hash backend calls — with the
    # pipelined seal (packfile.py seal_workers) this stage overlaps the
    # seal/write/upload stages instead of summing with them
    chunk_hash_s: float = 0.0


class DirPacker:
    def __init__(self, backend: ChunkerBackend, writer: PackfileWriter,
                 index: BlobIndex,
                 progress: Optional[Callable] = None,
                 batch_bytes: int = 256 * defaults.MiB,
                 should_pause: Optional[Callable] = None,
                 dedup_batch: Optional[Callable] = None,
                 dedup_index=None,
                 on_blob: Optional[Callable] = None):
        self.backend = backend
        self.writer = writer
        self.index = index
        self.progress = progress or (lambda **kw: None)
        self.batch_bytes = batch_bytes
        self.should_pause = should_pause or (lambda: None)
        # manifest hook: called (hash, size) for EVERY blob the snapshot
        # references — duplicates included — so the caller can record the
        # snapshot's full reachable-blob manifest (GC's mark source,
        # docs/lifecycle.md) without a second tree walk
        self.on_blob = on_blob
        # device dedup front.  ``dedup_index`` (a MeshDedupIndex or the
        # tiered front) is the full handle: pack batches then classify
        # through the backend's fused manifest+classify seam (on the GPU
        # backend the digests reach the table without leaving the card).
        # ``dedup_batch`` is the narrower legacy hook (batched
        # classify+insert callable); None for both = host-only dedup.
        self.dedup_index = dedup_index
        if dedup_batch is None and dedup_index is not None:
            dedup_batch = dedup_index.classify_insert
        self.dedup_batch = dedup_batch
        self._device_sync: List[bytes] = []
        self.stats = PackStats()
        # lag-bounded incremental emission (docs/dataflow.md): deadline
        # for the next forced partial-packfile emission
        self._emit_deadline = time.monotonic() + defaults.PACK_EMIT_MAX_LAG_S

    # --- blob plumbing -----------------------------------------------------

    def _add_blob(self, blob_hash: bytes, kind: BlobKind, data: bytes,
                  dup_hint: Optional[bool] = None) -> None:
        """Dedup-then-pack one blob (pack.rs:31-55 semantics).

        ``dup_hint`` is the device table's classification when the blob was
        part of a batched classify.  The host index is the authority: on
        disagreement the host verdict wins and the event is logged loudly —
        device=dup/host=new is expected-by-design (astronomically rare
        128-bit truncation collisions in the device table's key prefix,
        see device_dedup.py), and degrading beats failing the whole backup.
        """
        if self.on_blob is not None:
            self.on_blob(bytes(blob_hash), len(data))
        host_dup = self.index.is_duplicate(blob_hash)
        if dup_hint is not None and dup_hint != host_dup:
            self.stats.dedup_divergences += 1
            logging.getLogger(__name__).warning(
                "device/host dedup divergence on %s: device=%s host=%s; "
                "using host verdict", bytes(blob_hash).hex(), dup_hint,
                host_dup)
        if dup_hint is None and self.dedup_batch is not None:
            # blob classified host-side only (tree node or streamed chunk):
            # sync it into the device table at the next batch boundary
            self._device_sync.append(bytes(blob_hash))
        if host_dup:
            self.stats.chunks_deduped += 1
            self.stats.bytes_deduped += len(data)
            return
        self.index.mark_queued(blob_hash)
        self.should_pause()
        self.writer.add_blob(Blob(hash=blob_hash, kind=kind, data=data))

    def _flush_device_sync(self) -> None:
        if self.dedup_batch is not None and self._device_sync:
            self.dedup_batch(self._device_sync)
            self._device_sync.clear()

    def _maybe_emit_partial(self) -> None:
        """Incremental emission instead of end-of-tree flush: blobs
        buffered below the packfile target size must not wait for
        ``pack()``'s final flush longer than PACK_EMIT_MAX_LAG_S — on a
        tree of many small directories that flush used to be the ONLY
        emission, so the wire idled for the whole walk.  The deadline
        re-arms whenever the writer is empty, so steady target-size
        emission never pays extra sub-target packfiles."""
        now = time.monotonic()
        if not self.writer.pending_blobs:
            self._emit_deadline = now + defaults.PACK_EMIT_MAX_LAG_S
            return
        if now >= self._emit_deadline:
            self.writer.emit_partial()
            self._emit_deadline = now + defaults.PACK_EMIT_MAX_LAG_S

    def _add_tree(self, tree: Tree) -> bytes:
        encoded = tree.encode_bytes()
        h = blake3_hash(encoded)
        self._add_blob(h, BlobKind.TREE, encoded)
        return h

    def _tree_with_split(self, kind: TreeKind, name: str, meta: TreeMetadata,
                         children: List[bytes]) -> bytes:
        """Build one logical node, splitting into a next_sibling chain at
        TREE_MAX_CHILDREN (dir_packer.rs:313-363); returns the head hash."""
        cap = defaults.TREE_MAX_CHILDREN
        pages = [children[i:i + cap] for i in range(0, len(children), cap)] or [[]]
        next_hash: Optional[bytes] = None
        for page in reversed(pages):
            next_hash = self._add_tree(Tree(
                kind=kind, name=name, metadata=meta, children=list(page),
                next_sibling=next_hash))
        return next_hash

    # --- file chunking (the device-batched hot path) -----------------------

    def _pack_files(self, files: List[Path]) -> List[Optional[bytes]]:
        """Chunk+hash a batch of files; returns each file's tree hash
        (None for files that vanished or failed to read)."""
        hashes: List[Optional[bytes]] = [None] * len(files)
        batch_idx: List[int] = []
        batch_data: List[bytes] = []
        batch_meta: List[TreeMetadata] = []

        def flush_batch():
            if not batch_idx:
                return
            t0 = time.monotonic()
            hint_list = None
            if self.dedup_index is not None:
                # blobs classified host-side since the last batch (streamed
                # chunks, tree nodes) must reach the device table BEFORE
                # this batch is classified, or a re-occurrence of one of
                # them would read as device-new/host-dup and trip the
                # divergence guard in _add_blob
                self._flush_device_sync()
                # fused manifest+classify: on the GPU backend each digest
                # batch hands its accumulator to the table on the device
                # (zero per-batch host round trips)
                with tracing.span("packer.manifest_many"):
                    manifests, hint_list = \
                        self.backend.manifest_many_classified(
                            batch_data, self.dedup_index)
            else:
                with tracing.span("packer.manifest_many"):
                    manifests = self.backend.manifest_many(batch_data)
            dt = time.monotonic() - t0
            self.stats.chunk_hash_s += dt
            _STAGE_SECONDS.observe(dt, stage="chunk_hash")
            total_refs = sum(len(m) for m in manifests)
            if total_refs and hint_list is None:
                # one batched dedup classification per pack batch, whether
                # the device table or the host blob index answers it
                obs_profile.dispatch("index", actual_bytes=32 * total_refs,
                                     padded_bytes=32 * total_refs)
            hints = iter(())
            if hint_list is not None:
                hints = iter(hint_list)
            elif self.dedup_batch is not None:
                # legacy hook path (no full index handle): same sync-then-
                # classify ordering, one device round trip for the batch
                self._flush_device_sync()
                hints = iter(self.dedup_batch(
                    [ref.hash for m in manifests for ref in m]))
            for i, data, meta, manifest in zip(batch_idx, batch_data,
                                               batch_meta, manifests):
                for ref in manifest:
                    self.stats.chunks += 1
                    self._add_blob(ref.hash, BlobKind.FILE_CHUNK,
                                   data[ref.offset:ref.offset + ref.length],
                                   dup_hint=next(hints, None))
                hashes[i] = self._tree_with_split(
                    TreeKind.FILE, files[i].name, meta,
                    [ref.hash for ref in manifest])
                self.stats.files += 1
                self.progress(file=str(files[i]), bytes=len(data))
            self._flush_device_sync()
            self._maybe_emit_partial()
            batch_idx.clear()
            batch_data.clear()
            batch_meta.clear()

        pending = 0
        for i, path in enumerate(files):
            try:
                st = path.lstat()
                if st.st_size > self.batch_bytes:
                    # oversized file: stream it so memory stays bounded
                    hashes[i] = self._pack_file_streaming(path, st)
                    continue
                data = path.read_bytes()
            except OSError:
                self.stats.failed_files += 1
                continue
            self.stats.bytes_read += len(data)
            batch_idx.append(i)
            batch_data.append(data)
            batch_meta.append(TreeMetadata(
                size=len(data), mtime_ns=st.st_mtime_ns,
                ctime_ns=st.st_ctime_ns))
            pending += len(data)
            if pending >= self.batch_bytes:
                flush_batch()
                pending = 0
        flush_batch()
        return hashes

    def _pack_file_streaming(self, path: Path, st: os.stat_result) -> bytes:
        """Chunk one huge file through the backend's streaming manifest;
        blobs pack as chunks finalize, so memory stays ~one segment.

        The file is mmapped and fed as memoryview windows
        (dir_packer.rs:252's memmap2 analog), so the packer never holds a
        second buffered copy of the file; the backend still assembles one
        per-segment buffer when it splices the carry onto each window.
        The same documented race as the reference applies: a file
        mutating mid-chunk produces a wrong (detectably inconsistent)
        backup of that file, never a crash — mmap failures (e.g. the
        file was truncated to empty after the stat) fall back to plain
        reads.
        """
        import mmap as _mmap

        children: List[bytes] = []

        def emit(ref, data):
            self.stats.chunks += 1
            self.stats.bytes_read += ref.length
            children.append(ref.hash)
            self._add_blob(ref.hash, BlobKind.FILE_CHUNK, data)

        with open(path, "rb") as f:
            try:
                mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
            except (OSError, ValueError):
                mm = None  # empty/truncated/unmappable: plain reads
            t0 = time.monotonic()
            if mm is None:
                self.backend.manifest_stream(
                    f.read, segment_bytes=self.batch_bytes, emit=emit)
            else:
                view = memoryview(mm)
                pos = 0

                def read(n: int):
                    nonlocal pos
                    out = view[pos:pos + n]
                    pos += len(out)
                    return out

                try:
                    self.backend.manifest_stream(
                        read, segment_bytes=self.batch_bytes, emit=emit)
                finally:
                    view.release()
                    try:
                        mm.close()
                    except BufferError:
                        # an in-flight exception's traceback still holds
                        # window slices; closing would mask the real
                        # error — let GC drop the mapping instead
                        pass
        dt = time.monotonic() - t0
        self.stats.chunk_hash_s += dt
        _STAGE_SECONDS.observe(dt, stage="chunk_hash")
        if children:
            # the streamed file's chunks were classified host-side one by
            # one; account them as a single per-file dedup pass
            obs_profile.dispatch("index", actual_bytes=32 * len(children),
                                 padded_bytes=32 * len(children))
        self.stats.files += 1
        self.progress(file=str(path), bytes=st.st_size)
        return self._tree_with_split(
            TreeKind.FILE, path.name,
            TreeMetadata(size=st.st_size, mtime_ns=st.st_mtime_ns,
                         ctime_ns=st.st_ctime_ns),
            children)

    # --- directory walk ----------------------------------------------------

    def pack(self, root: Path) -> bytes:
        """Pack ``root`` recursively; returns the snapshot id (root hash)."""
        root = Path(root)
        if not root.is_dir():
            raise NotADirectoryError(str(root))
        # discover directories breadth-first, then process deepest-first so
        # children always hash before parents (dir_packer.rs:89-132)
        order: List[Path] = [root]
        for d in order:
            try:
                subdirs = sorted(p for p in d.iterdir()
                                 if p.is_dir() and not p.is_symlink())
            except OSError:
                subdirs = []
            order.extend(subdirs)
        dir_hash: dict = {}
        for d in reversed(order):
            try:
                entries = sorted(d.iterdir())
            except OSError:
                entries = []
            files = [p for p in entries
                     if p.is_file() and not p.is_symlink()]
            subdirs = [p for p in entries if p.is_dir() and not p.is_symlink()]
            children = [h for h in self._pack_files(files) if h is not None]
            children.extend(dir_hash[s] for s in subdirs if s in dir_hash)
            try:
                st = d.stat()
                meta = TreeMetadata(size=0, mtime_ns=st.st_mtime_ns,
                                    ctime_ns=st.st_ctime_ns)
            except OSError:  # directory vanished mid-walk: keep its children
                meta = TreeMetadata()
            name = "" if d == root else d.name
            dir_hash[d] = self._tree_with_split(TreeKind.DIR, name, meta,
                                                children)
            self.stats.dirs += 1
            self._maybe_emit_partial()
        self._flush_device_sync()
        self.writer.flush()
        return dir_hash[root]
