"""Persistent event journal: size-rotated append-only JSONL + panic dumps.

Counterpart of ``backuwup_tpu/obs/journal.py``, copied so that the port imports
nothing of the JAX package; what it writes is byte-identical.

Every StatusEvent the messenger emits, every span close, every
retry/backoff firing, and every fault-plane injection lands here as one
JSON line, so a post-mortem can replay exactly what the process saw —
with ``trace_id`` fields joining the lines of one backup across the
pack thread, the transfer plane, and (via the wire propagation in
:mod:`backuwup_tpu_torch.obs.trace`) the peer that stored the bytes.

The plane follows the fault-plane idiom (utils/faults.py): a module
global :data:`JOURNAL` that is ``None`` unless installed, so the hook
call — :func:`emit` — costs one attribute load on the production path
and never raises into the data path.  A process started with
``BKW_JOURNAL=<path>`` gets the journal with no plumbing.

Rotation is by size: when the live file passes ``max_bytes`` it is
renamed to ``<path>.1`` (older generations shift up, the oldest beyond
``keep`` is dropped) and a fresh file starts.  :meth:`Journal.panic_dump`
writes ``<path stem>.panic.json`` containing the registry snapshot plus
the last N journal lines — the flight recorder read-out for the
``messenger.panic`` / excepthook path.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import IO, List, Optional

from .. import defaults
from ..utils import durable
from . import metrics as _metrics


class Journal:
    """One append-only JSONL journal with size rotation."""

    def __init__(self, path, max_bytes: Optional[int] = None,
                 keep: Optional[int] = None):
        self.path = Path(path)
        self.max_bytes = int(defaults.OBS_JOURNAL_MAX_BYTES
                             if max_bytes is None else max_bytes)
        self.keep = int(defaults.OBS_JOURNAL_KEEP if keep is None else keep)
        self._lock = threading.Lock()
        self._fh: Optional[IO[str]] = None
        self.lines_written = 0
        self.rotations = 0
        self.path.parent.mkdir(parents=True, exist_ok=True)

    # --- writing -----------------------------------------------------------

    def emit(self, kind: str, **fields) -> None:
        rec = {"ts": round(time.time(), 6), "kind": kind}
        rec.update(fields)
        line = json.dumps(rec, sort_keys=True, default=str) + "\n"
        with self._lock:
            fh = self._open_locked()
            fh.write(line)
            fh.flush()
            self.lines_written += 1
            if fh.tell() >= self.max_bytes:
                self._rotate_locked()

    def _open_locked(self) -> IO[str]:
        if self._fh is None or self._fh.closed:
            self._fh = open(self.path, "a", encoding="utf-8")
        return self._fh

    def _rotate_locked(self) -> None:
        self._fh.close()
        self._fh = None
        oldest = self.path.with_name(self.path.name + f".{self.keep}")
        if oldest.exists():
            oldest.unlink()
        for i in range(self.keep - 1, 0, -1):
            src = self.path.with_name(self.path.name + f".{i}")
            if src.exists():
                src.rename(self.path.with_name(self.path.name + f".{i + 1}"))
        if self.keep > 0:
            self.path.rename(self.path.with_name(self.path.name + ".1"))
        else:
            self.path.unlink()
        # one barrier for the whole rename chain: a crash mid-rotation may
        # lose a generation shift but never a committed journal file
        durable.fsync_dir(self.path.parent)
        self.rotations += 1

    def close(self) -> None:
        with self._lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.close()
            self._fh = None

    # --- reading -----------------------------------------------------------

    def files(self) -> List[Path]:
        """Journal files oldest-first (rotated generations then live)."""
        out = [self.path.with_name(self.path.name + f".{i}")
               for i in range(self.keep, 0, -1)]
        out.append(self.path)
        return [p for p in out if p.exists()]

    def tail(self, n: int) -> List[dict]:
        """Last ``n`` parsed records across rotation boundaries (bad
        lines — a torn write at crash time — are skipped)."""
        lines: List[str] = []
        for p in self.files():
            try:
                lines.extend(p.read_text(encoding="utf-8").splitlines())
            except OSError:
                continue
        out = []
        for line in lines[-max(int(n), 0):]:
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
        return out

    # --- post-mortem -------------------------------------------------------

    def panic_dump(self, message: str,
                   tail_n: Optional[int] = None) -> Path:
        """Flight-recorder read-out: metrics snapshot + journal tail."""
        tail_n = defaults.OBS_PANIC_TAIL_LINES if tail_n is None else tail_n
        out = self.path.with_name(self.path.name + ".panic.json")
        doc = {"ts": round(time.time(), 6), "message": str(message),
               "metrics": _metrics.registry().snapshot(),
               "journal_tail": self.tail(tail_n)}
        tmp = out.with_name(out.name + ".tmp")
        tmp.write_text(json.dumps(doc, sort_keys=True, default=str),
                       encoding="utf-8")
        durable.commit_replace(tmp, out)
        return out


#: The installed journal; None (the default) disables every hook.
JOURNAL: Optional[Journal] = None


def install(journal: Journal) -> Journal:
    global JOURNAL
    JOURNAL = journal
    return journal


def uninstall() -> None:
    global JOURNAL
    j, JOURNAL = JOURNAL, None
    if j is not None:
        j.close()


def get() -> Optional[Journal]:
    return JOURNAL


def emit(kind: str, **fields) -> None:
    """Record one line on the installed journal; no-op when none is
    installed, and a failing disk never raises into the data path."""
    j = JOURNAL
    if j is None:
        return
    try:
        j.emit(kind, **fields)
    except Exception:
        pass


def panic(message: str) -> Optional[Path]:
    """Write the panic dump on the installed journal (None when absent)."""
    j = JOURNAL
    if j is None:
        return None
    try:
        j.emit("panic", message=str(message))
        return j.panic_dump(message)
    except Exception:
        return None


# env activation at import time (the faults.py idiom): a process started
# with BKW_JOURNAL=<path> journals with no test or app plumbing
if os.environ.get("BKW_JOURNAL"):
    JOURNAL = Journal(os.environ["BKW_JOURNAL"])
