"""Durable-commit helpers: fsync-disciplined atomic file replacement.

Counterpart of ``backuwup_tpu/utils/durable.py``, copied so that the port imports
nothing of the JAX package; what it writes is byte-identical.

ALICE (Pillai et al., OSDI'14) showed that "atomic" tmp-write +
``os.replace`` protocols quietly assume two things POSIX never promised:
that the tmp file's *contents* reach disk before the rename, and that
the rename itself (a directory-entry update) is persisted.  A crash
between either pair leaves a zero-length or stale file behind a fresh
name.  Every commit point in this codebase (packfile seal, blob-index
save, challenge-table save, journal rotation, partial-transfer meta)
funnels through the helpers here so the discipline lives in one place:

* :func:`fsync_file` — flush one file's data+metadata;
* :func:`fsync_dir` — persist a directory's entries (the rename);
* :func:`commit_replace` — fsync tmp, ``os.replace``, fsync parent:
  after it returns, the destination durably holds the new bytes;
* :func:`write_replace` — the whole write-tmp/commit dance for callers
  that start from a byte string.

``fsync`` can be disabled process-wide with ``BKW_FSYNC=0`` (pure-tmpfs
test runs where durability is moot); the *atomicity* of the replace is
kept either way.  Directory fsync failures are swallowed — some
filesystems (and seccomp profiles) refuse ``fsync`` on a directory fd,
and a best-effort barrier beats an unconditional crash.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Union

_PathLike = Union[str, "os.PathLike[str]"]

#: Process-wide switch; tests may flip it, ``BKW_FSYNC=0`` disables.
FSYNC_ENABLED = os.environ.get("BKW_FSYNC", "1").lower() not in (
    "0", "false", "no")


def fsync_file(path: _PathLike) -> None:
    """Flush ``path``'s contents to stable storage (no-op when fsync is
    disabled)."""
    if not FSYNC_ENABLED:
        return
    fd = os.open(os.fspath(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: _PathLike) -> None:
    """Persist directory ``path``'s entries — the half of a rename that
    lives in the parent, not the file.  Best-effort: filesystems that
    reject directory fsync are tolerated."""
    if not FSYNC_ENABLED:
        return
    try:
        fd = os.open(os.fspath(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def commit_replace(tmp: _PathLike, dst: _PathLike) -> None:
    """Durably commit ``tmp`` over ``dst``: fsync the tmp file, rename
    atomically, then fsync the parent directory so the rename survives a
    crash.  ``tmp`` and ``dst`` must share a parent (same-directory
    rename is the only atomic one)."""
    fsync_file(tmp)
    os.replace(tmp, dst)
    fsync_dir(Path(os.fspath(dst)).parent)


def write_replace(dst: _PathLike, data: bytes) -> None:
    """Durably publish ``data`` at ``dst`` via a sibling ``.tmp`` file
    and :func:`commit_replace`."""
    dst = Path(os.fspath(dst))
    tmp = dst.with_name(dst.name + ".tmp")
    tmp.write_bytes(data)
    commit_replace(tmp, dst)
