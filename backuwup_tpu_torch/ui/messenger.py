"""Status messenger: the progress/telemetry hub.

Counterpart of ``backuwup_tpu/ui/messenger.py``, copied so that the port
imports nothing of the JAX package.

Re-designs ``client/src/ui/ws_status_message.rs``: a process-wide pub/sub
of log lines, lifecycle events, and debounced progress snapshots that UI
front-ends (CLI, web dashboard, tests) subscribe to.  Progress updates are
coalesced to at most one per 100 ms (``:134-141``); subscribers are
lag-tolerant bounded queues (``ui/ws.rs:31-56``).

Every event also flows into the observability plane: the journal (when
installed) records each StatusEvent as one JSONL line, and per-kind /
per-outcome counters land in the metrics registry so ``GET /metrics``
carries the audit/erasure/transfer story without a UI attached.
"""

from __future__ import annotations

import json
import logging
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional

from .. import defaults
from ..obs import journal as obs_journal
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

logger = logging.getLogger(__name__)

_EVENTS = obs_metrics.counter(
    "bkw_messenger_events_total", "StatusEvents emitted by kind", ("kind",))
_SUB_ERRORS = obs_metrics.counter(
    "bkw_messenger_subscriber_errors_total",
    "Events dropped by a raising subscriber callback", ("subscriber",))
_AUDITS = obs_metrics.counter(
    "bkw_audit_total", "Audit verdicts by outcome", ("outcome",))
_ERASURE = obs_metrics.counter(
    "bkw_erasure_events_total", "Erasure-coding events by outcome",
    ("outcome",))


def _sub_label(cb: Callable) -> str:
    return getattr(cb, "__qualname__", None) or repr(cb)


@dataclass
class Progress:
    """ws_status_message.rs:48-61."""

    current_file: str = ""
    files_done: int = 0
    files_failed: int = 0
    size_estimate: int = 0
    bytes_on_disk: int = 0
    bytes_transmitted: int = 0
    running: bool = False


@dataclass
class StatusEvent:
    kind: str  # message | progress | backup_started | backup_finished | ...
    payload: dict = field(default_factory=dict)
    ts: float = field(default_factory=time.time)

    def to_json(self) -> str:
        return json.dumps({"kind": self.kind, "payload": self.payload,
                           "ts": self.ts}, sort_keys=True)


class Messenger:
    def __init__(self, debounce_s: float = defaults.PROGRESS_DEBOUNCE_S,
                 history: int = 1000):
        self._subs: List[Callable] = []
        self._debounce_s = debounce_s
        self._last_progress = 0.0
        self.progress_state = Progress()
        self.history: deque = deque(maxlen=history)
        self._sub_logged: set = set()  # subscribers whose first failure logged

    def subscribe(self, cb: Callable[[StatusEvent], None]) -> Callable:
        self._subs.append(cb)
        return lambda: self._subs.remove(cb)

    def _emit(self, event: StatusEvent) -> None:
        self.history.append(event)
        _EVENTS.inc(kind=event.kind)
        obs_journal.emit("status", event=event.kind, payload=event.payload,
                         trace_id=obs_trace.current_trace_id())
        for cb in list(self._subs):
            try:
                cb(event)
            except Exception:
                # lag-tolerant: a broken subscriber never blocks others —
                # but the drops are counted, and the first failure per
                # subscriber is logged so it cannot stay invisible forever
                label = _sub_label(cb)
                _SUB_ERRORS.inc(subscriber=label)
                if label not in self._sub_logged:
                    self._sub_logged.add(label)
                    logger.exception(
                        "messenger subscriber %s raised on %s event"
                        " (first failure; further drops only counted)",
                        label, event.kind)

    # --- producers ---------------------------------------------------------

    def log(self, message: str) -> None:
        self._emit(StatusEvent("message", {"text": message}))

    def progress(self, **fields) -> None:
        """Debounced snapshot merge (at most one event per 100 ms)."""
        p = self.progress_state
        if "file" in fields:
            p.current_file = fields.pop("file")
            p.files_done += 1
        for k, v in fields.items():
            if hasattr(p, k):
                setattr(p, k, v)
        now = time.time()
        if now - self._last_progress >= self._debounce_s:
            self._last_progress = now
            self._emit(StatusEvent("progress", asdict(p)))

    def tick(self) -> None:
        """Undebounced snapshot push (the 400 ms ticker and late-joining
        UI clients; backup/mod.rs:109-114)."""
        self._emit(StatusEvent("progress", asdict(self.progress_state)))

    def peers(self, peers: list) -> None:
        """Peer-ledger telemetry frame (ws_status_message.rs:128-163)."""
        self._emit(StatusEvent("peers", {"peers": peers}))

    def config(self, cfg: dict) -> None:
        self._emit(StatusEvent("config", cfg))

    def audit(self, peer: str, outcome: str, detail: str = "",
              demoted: bool = False) -> None:
        """Storage-audit verdict frame (outcome: pass | fail | miss)."""
        _AUDITS.inc(outcome=outcome)
        self._emit(StatusEvent("audit", {"peer": peer, "outcome": outcome,
                                         "detail": detail,
                                         "demoted": demoted}))

    def erasure(self, subject: str, outcome: str, shards: int = 0,
                rebuilt: int = 0) -> None:
        """Erasure-coding telemetry frame (outcome: placed | assembled |
        rebuilt); ``subject`` is a packfile id hex or a phase label."""
        _ERASURE.inc(outcome=outcome)
        self._emit(StatusEvent("erasure", {"subject": subject,
                                           "outcome": outcome,
                                           "shards": shards,
                                           "rebuilt": rebuilt}))

    def transfer(self, peer: str, outcome: str, size: int = 0,
                 inflight: int = 0, inflight_bytes: int = 0,
                 wait_ms: float = 0.0, send_ms: float = 0.0,
                 label: str = "", stages: Optional[Dict] = None,
                 overlap: Optional[Dict] = None) -> None:
        """Transfer-plane telemetry frame (net/transfer.py).

        ``outcome``: ``sent`` | ``failed`` per completed transfer, or
        ``summary`` for the end-of-run per-stage roll-up (``stages`` maps
        stage name -> seconds: seal/write/wait/send, ``overlap`` is the
        engine's wall-vs-max-stage verdict, docs/dataflow.md).
        ``inflight`` / ``inflight_bytes`` are the plane's gauges at
        emission time.
        """
        payload = {"peer": peer, "outcome": outcome, "size": size,
                   "inflight": inflight, "inflight_bytes": inflight_bytes,
                   "wait_ms": round(wait_ms, 3), "send_ms": round(send_ms, 3),
                   "label": label}
        if stages:
            payload["stages"] = {k: round(float(v), 4)
                                 for k, v in stages.items()}
        if overlap:
            payload["overlap"] = overlap
        self._emit(StatusEvent("transfer", payload))

    def error(self, text: str) -> None:
        self._emit(StatusEvent("error", {"text": text}))

    def _flush_progress(self) -> None:
        """Undebounced final snapshot: a run's last progress must never be
        eaten by the debounce window (UIs would end on a stale percent)."""
        self._last_progress = time.time()
        self._emit(StatusEvent("progress", asdict(self.progress_state)))

    def backup_started(self) -> None:
        self.progress_state = Progress(running=True)
        self._emit(StatusEvent("backup_started"))

    def backup_finished(self, snapshot: bytes) -> None:
        self.progress_state.running = False
        self._flush_progress()
        self._emit(StatusEvent("backup_finished",
                               {"snapshot": bytes(snapshot).hex()}))

    def restore_started(self) -> None:
        self.progress_state = Progress(running=True)
        self._emit(StatusEvent("restore_started"))

    def restore_finished(self) -> None:
        self.progress_state.running = False
        self._flush_progress()
        self._emit(StatusEvent("restore_finished"))

    def panic(self, message: str) -> None:
        """Fatal-error report hook (client main.rs:53-61 panic hook):
        besides the UI frame, trip the journal's flight-recorder dump."""
        self._emit(StatusEvent("panic", {"text": message}))
        obs_journal.panic(message)
