"""Perfetto timeline export: journals -> Chrome trace-event JSON.

Counterpart of ``backuwup_tpu/obs/timeline.py``, copied so that the port
imports nothing of the JAX package.

Turns the PR-5 span tree into a viewable picture: every ``span`` line a
journal recorded becomes a complete ("X") trace event, every other
journal line an instant ("i"), and multiple clients' journals merge
into one document — each journal gets its own Perfetto process row,
while the trace ids that already ride the p2p and client<->server
envelopes key the cross-process correlation (sender pack spans and
receiver store spans carry the same ``trace_id`` arg, and
``trace_id=`` filtering cuts the merged view down to one backup).

Journal span lines record the CLOSE time (``ts``) plus ``dur_s``, so an
event's start is ``ts - dur_s``.  Spans sharing a trace are laid on one
Perfetto track (tid) per process; parent spans close after their
children, so the nesting renders as a flame without explicit stack
events.  Stdlib-only, like the rest of ``obs/``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_GENERATOR = "backuwup-tpu obs.timeline"


def journal_records(path) -> List[dict]:
    """Parse one journal JSONL file, silently skipping torn/garbage
    lines (a crash mid-write must not make the timeline unreadable)."""
    out = []
    p = Path(path)
    if not p.exists():
        return out
    with p.open("r", encoding="utf-8", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and "ts" in rec:
                out.append(rec)
    return out


def _us(seconds: float) -> int:
    return int(round(float(seconds) * 1e6))


def to_trace_events(sources: Sequence[Tuple[str, Iterable[dict]]],
                    trace_id: Optional[str] = None) -> List[dict]:
    """Convert ``(label, records)`` journal sources into trace events.

    Each source becomes one Perfetto process (pid 1..N, named via an
    "M" metadata event).  Within a process, every distinct trace id is
    one track (tid, by first appearance); records without a trace id
    share track 0.  With ``trace_id`` set, only records carrying that
    exact id survive — the merged cross-process view of one backup.
    """
    events: List[dict] = []
    for pid, (label, records) in enumerate(sources, start=1):
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": str(label)},
        })
        tids: Dict[str, int] = {}
        for rec in records:
            rec_tid = rec.get("trace_id")
            if trace_id is not None and rec_tid != trace_id:
                continue
            if rec_tid:
                tid = tids.setdefault(rec_tid, len(tids) + 1)
            else:
                tid = 0
            ts = float(rec.get("ts", 0.0))
            if rec.get("kind") == "span":
                dur = float(rec.get("dur_s") or 0.0)
                events.append({
                    "name": str(rec.get("name", "span")),
                    "cat": "span", "ph": "X",
                    "ts": _us(ts - dur), "dur": max(_us(dur), 1),
                    "pid": pid, "tid": tid,
                    "args": {"trace_id": rec_tid,
                             "span_id": rec.get("span_id"),
                             "parent_id": rec.get("parent_id")},
                })
            else:
                args = {k: v for k, v in rec.items()
                        if k not in ("ts", "kind")}
                events.append({
                    "name": str(rec.get("kind", "event")),
                    "cat": "journal", "ph": "i", "s": "t",
                    "ts": _us(ts), "pid": pid, "tid": tid,
                    "args": args,
                })
    # Deterministic order: metadata first, then by time within pid ties.
    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0),
                               e["pid"], e["tid"], e["name"]))
    return events


def build_timeline(sources: Sequence[Tuple[str, Iterable[dict]]],
                   trace_id: Optional[str] = None) -> dict:
    """The full Chrome trace-event document (Perfetto's legacy JSON
    format: load via ui.perfetto.dev or chrome://tracing)."""
    return {
        "traceEvents": to_trace_events(sources, trace_id=trace_id),
        "displayTimeUnit": "ms",
        "otherData": {"generator": _GENERATOR},
    }


def export_timeline(paths: Sequence, out_path,
                    trace_id: Optional[str] = None,
                    labels: Optional[Sequence[str]] = None) -> dict:
    """Merge journal files into one timeline JSON written to
    ``out_path``; returns the document.  ``labels`` names the Perfetto
    process rows (defaults to each file's stem)."""
    sources = []
    for i, path in enumerate(paths):
        label = (labels[i] if labels is not None and i < len(labels)
                 else Path(path).stem)
        sources.append((label, journal_records(path)))
    doc = build_timeline(sources, trace_id=trace_id)
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n",
                   encoding="utf-8")
    return doc
