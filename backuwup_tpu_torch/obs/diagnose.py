"""Evidence-ranked root-cause explainer for SLO breaches.

Counterpart of ``backuwup_tpu/obs/diagnose.py``, copied so that the port
imports nothing of the JAX package.

Dapper's core claim (PAPERS.md) is that telemetry becomes actionable
when signals from different planes are *correlated*, not merely
collected.  :func:`explain` does exactly that at breach time: it takes
the breach window and scores every piece of evidence that overlaps it —

* **journal events** — armed fault-site injections (``fault`` events,
  including ``crash.*`` crashpoints and ``dial.dead``/``send.dead``
  kill evidence), durability status changes, demotions/promotions,
  sequence breaks, GC/repair activity;
* **anomalous series** — the recorder's robust-zscore flags over the
  same window (obs/series.py);
* **slow trace spans** — ``span`` journal events whose duration is an
  outlier against the window's other spans of the same name.

Scoring is layered so harder evidence outranks softer evidence: an
injected fault in the window beats a durability transition, which beats
a generic lifecycle event, which beats a statistical anomaly.  Within a
layer, repetition raises the score slightly (capped) and ties break on
the cause id — every input is rounded before ranking, so the same
breach against the same evidence yields a byte-identical report.  That
determinism is load-bearing: the sim plane gates on
``same seed => identical diagnosis_report``.

The report is journaled (``diagnosis_report``) for ``obs_dump.py
--explain`` and returned to the caller (the scenario harness asserts
the armed fault site ranks in the top-3 causes).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .. import defaults
from . import journal as obs_journal
from . import metrics as obs_metrics

_C_REPORTS = obs_metrics.counter(
    "bkw_diagnosis_reports_total",
    "Breach diagnosis reports generated", ("objective",))

#: Evidence-layer base scores; faults must outrank everything a healthy
#: run can emit, statistical anomalies must rank below any hard event.
_SCORE_FAULT = 4.0
_SCORE_DURABILITY = 2.5
_SCORE_EVENT = 2.0
_SCORE_SPAN = 1.5
_SCORE_SERIES_MAX = 1.0
#: Repetition bonus per extra occurrence of the same cause, capped.
_REPEAT_BONUS = 0.1
_REPEAT_CAP = 1.0

#: Journal kinds that are infrastructure, not evidence.
_SKIP_KINDS = frozenset({
    "slo_breach", "slo_recovered", "slo_diagnose_error",
    "diagnosis_report", "series_sample", "series_sample_error",
})


def _event_cause(ev: dict):
    """(cause_id, kind, base_score, evidence) for one journal event, or
    None when the event carries no diagnostic weight."""
    kind = str(ev.get("kind", ""))
    if not kind or kind in _SKIP_KINDS:
        return None
    if kind == "fault":
        site = str(ev.get("site", "?"))
        return (f"fault:{site}", "fault", _SCORE_FAULT,
                {"site": site})
    if kind == "durability":
        status = str(ev.get("status", "?"))
        return (f"durability:{status}", "durability", _SCORE_DURABILITY,
                {"status": status, "summary": ev.get("summary")})
    if kind == "span":
        return None  # handled by _span_causes (needs peer comparison)
    detail = {}
    for field in ("site", "peer", "client", "status", "reason"):
        if field in ev:
            detail[field] = ev[field]
    return (f"event:{kind}", "event", _SCORE_EVENT, detail)


def _span_causes(spans: List[dict]) -> List[tuple]:
    """Flag span names whose worst duration dominates the window: the
    max must be >= 3x the window median for that name (and the name must
    have >= 2 samples, else there is no baseline to dominate)."""
    by_name: Dict[str, List[float]] = {}
    for ev in spans:
        try:
            by_name.setdefault(str(ev.get("name", "?")), []).append(
                float(ev.get("dur_s", 0.0)))
        except (TypeError, ValueError):
            continue
    out = []
    for name, durs in sorted(by_name.items()):
        if len(durs) < 2:
            continue
        durs_sorted = sorted(durs)
        med = durs_sorted[len(durs_sorted) // 2]
        worst = durs_sorted[-1]
        if med > 0 and worst >= 3.0 * med:
            out.append((f"span:{name}", "span", _SCORE_SPAN,
                        {"name": name, "worst_s": round(worst, 6),
                         "median_s": round(med, 6),
                         "samples": len(durs)}))
    return out


def explain(breach, recorder=None, events: Optional[List[dict]] = None,
            now: Optional[float] = None,
            window_s: Optional[float] = None,
            top: Optional[int] = None) -> dict:
    """Build the ranked diagnosis report for one breach.

    ``breach`` is an ``obs.slo.Breach`` or its dict form.  ``events``
    is the journal-event window to correlate (dicts with at least
    ``kind``; ``ts`` filters when present relative to ``now``) — when
    None, the installed journal's tail is used.  ``recorder`` supplies
    the anomaly flags; None skips the series layer (the sim plane's
    synthetic-events path).  Deterministic for identical inputs.
    """
    bd = breach.to_dict() if hasattr(breach, "to_dict") else dict(breach)
    window_s = float(defaults.DIAGNOSE_WINDOW_S
                     if window_s is None else window_s)
    top = int(defaults.DIAGNOSE_TOP_CAUSES if top is None else top)
    now = float(bd.get("t", 0.0)) if now is None else float(now)

    if events is None:
        jr = obs_journal.get()
        events = jr.tail(512) if jr is not None else []

    causes: Dict[str, dict] = {}

    def add(cause_id, kind, score, evidence):
        cur = causes.get(cause_id)
        if cur is None:
            causes[cause_id] = {"id": cause_id, "kind": kind,
                                "score": score, "count": 1,
                                "evidence": evidence}
        else:
            cur["count"] += 1
            cur["score"] = min(cur["score"] + _REPEAT_BONUS,
                               score + _REPEAT_CAP)

    spans: List[dict] = []
    lo = now - window_s
    windowed = 0
    for ev in events:
        if not isinstance(ev, dict):
            continue
        ts = ev.get("ts")
        if ts is not None:
            try:
                ts = float(ts)
            except (TypeError, ValueError):
                ts = None
        if ts is not None and not (lo <= ts <= now):
            continue
        windowed += 1
        if str(ev.get("kind", "")) == "span":
            spans.append(ev)
            continue
        got = _event_cause(ev)
        if got is not None:
            add(*got)

    for got in _span_causes(spans):
        add(*got)

    if recorder is not None:
        for a in recorder.anomalies(window_s):
            score = round(min(abs(a["z"]), 10.0) / 10.0
                          * _SCORE_SERIES_MAX, 4)
            add(f"series:{a['key']}", "series", score,
                {"z": a["z"], "last": a["last"]})

    ranked = sorted(causes.values(),
                    key=lambda c: (-round(c["score"], 4), c["id"]))
    report = {
        "objective": bd.get("objective", "?"),
        "status": bd.get("status", "?"),
        "t": round(now, 6),
        "window_s": round(window_s, 3),
        "evidence_events": windowed,
        "causes": [{"id": c["id"], "kind": c["kind"],
                    "score": round(c["score"], 4),
                    "count": c["count"], "evidence": c["evidence"]}
                   for c in ranked[:top]],
    }
    _C_REPORTS.inc(objective=report["objective"])
    obs_journal.emit("diagnosis_report", **report)
    return report
