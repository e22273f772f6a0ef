"""Directory unpacker: content-addressed snapshot -> filesystem tree.

Counterpart of ``backuwup_tpu/snapshot/unpacker.py``.

Re-designs ``client/src/backup/filesystem/dir_unpacker.rs``: breadth-first
walk from the snapshot root, ``next_sibling`` chains re-joined into full
child lists (``:104-115``), files reassembled chunk by chunk, mtimes
restored (``:95-101``).
"""

from __future__ import annotations

import os
from collections import deque
from pathlib import Path
from typing import Callable, List, Optional

from ..wire import Blob, BlobKind, Tree, TreeKind


class RestoreError(Exception):
    pass


def fetch_full_tree(resolve: Callable[[bytes], Blob], head_hash: bytes) -> Tree:
    """Follow the sibling chain, merging children (dir_unpacker.rs:104-115)."""
    blob = resolve(head_hash)
    if blob.kind != BlobKind.TREE:
        raise RestoreError(f"blob {bytes(head_hash).hex()} is not a tree")
    tree = Tree.decode_bytes(blob.data)
    children: List[bytes] = list(tree.children)
    nxt = tree.next_sibling
    while nxt is not None:
        page = Tree.decode_bytes(resolve(nxt).data)
        children.extend(page.children)
        nxt = page.next_sibling
    tree.children = children
    tree.next_sibling = None
    return tree


def snapshot_coverage_gap(resolve: Callable[[bytes], Blob],
                          has_blob: Callable[[bytes], bool],
                          snapshot_hash: bytes) -> Optional[bytes]:
    """Walk the snapshot's tree graph without writing anything; return the
    first unresolvable blob hash, or ``None`` when every tree and file
    chunk is present.  Lets a restore with failed peer streams proceed
    anyway when the restored data already covers the snapshot (e.g. a
    phantom negotiated peer that stores nothing — see the matcher's
    crash-window note in net/server.py)."""
    try:
        root = fetch_full_tree(resolve, snapshot_hash)
    except Exception:
        return bytes(snapshot_hash)
    queue = deque([root])
    while queue:
        tree = queue.popleft()
        for child_hash in tree.children:
            if tree.kind == TreeKind.DIR:
                try:
                    queue.append(fetch_full_tree(resolve, child_hash))
                except Exception:
                    return bytes(child_hash)
            elif not has_blob(child_hash):
                return bytes(child_hash)
    return None


class DirUnpacker:
    """``resolve`` maps a blob hash to a :class:`Blob` (index + reader)."""

    def __init__(self, resolve: Callable[[bytes], Blob],
                 progress: Optional[Callable] = None):
        self.resolve = resolve
        self.progress = progress or (lambda **kw: None)
        self.files_restored = 0
        self.bytes_restored = 0

    def _restore_file(self, tree: Tree, path: Path) -> None:
        with open(path, "wb") as f:
            for chunk_hash in tree.children:
                blob = self.resolve(chunk_hash)
                if blob.kind != BlobKind.FILE_CHUNK:
                    raise RestoreError(
                        f"file child {bytes(chunk_hash).hex()} is not a chunk")
                f.write(blob.data)
                self.bytes_restored += len(blob.data)
        if tree.metadata.mtime_ns:
            os.utime(path, ns=(tree.metadata.mtime_ns, tree.metadata.mtime_ns))
        self.files_restored += 1
        self.progress(file=str(path))

    def unpack(self, snapshot_hash: bytes, dest: Path) -> None:
        dest = Path(dest)
        dest.mkdir(parents=True, exist_ok=True)
        root = fetch_full_tree(self.resolve, snapshot_hash)
        if root.kind != TreeKind.DIR:
            raise RestoreError("snapshot root is not a directory tree")
        queue = deque([(root, dest)])
        dir_times = []
        while queue:
            tree, path = queue.popleft()
            path.mkdir(parents=True, exist_ok=True)
            if tree.metadata.mtime_ns:
                dir_times.append((path, tree.metadata.mtime_ns))
            for child_hash in tree.children:
                child = fetch_full_tree(self.resolve, child_hash)
                if child.kind == TreeKind.DIR:
                    queue.append((child, path / child.name))
                else:
                    self._restore_file(child, path / child.name)
        # directory mtimes last, depth-first, so file writes don't clobber
        for path, mtime_ns in reversed(dir_times):
            os.utime(path, ns=(mtime_ns, mtime_ns))
