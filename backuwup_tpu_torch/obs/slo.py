"""Declarative SLOs evaluated as multi-window burn rates.

Counterpart of ``backuwup_tpu/obs/slo.py``, copied so that the port
imports nothing of the JAX package.

The catalog (``defaults.SLO_CATALOG``) states the system's service-level
objectives as data: which ``bkw_*`` family is the bad-event signal, what
fraction of bad events the error budget tolerates, and how the bad
fraction is derived (counter rate, event ratio, histogram quantile,
gauge floor).  :class:`SLOMonitor` evaluates every objective over the
Google-SRE multi-window scheme: ``burn = bad_fraction / budget`` is
computed for a fast window pair (5 m / 1 h) and a slow pair (6 h / 3 d);
the objective is **violated** when both fast windows burn at/above
``SLO_FAST_BURN`` (an active incident — at 14.4x the month's budget
dies in ~2 days) and **degraded** when both slow windows burn at/above
``SLO_SLOW_BURN`` (a smoldering leak).  Requiring both windows of a
pair keeps one spike from paging and keeps a long-cleared incident from
re-paging — the standard reset/derail trade the SRE workbook describes.

Everything reads from a :class:`~backuwup_tpu_torch.obs.series.SeriesRecorder`
— never the wall clock and never the raw registry — so the same monitor
runs on virtual time under the sim driver (a simulated week of burn
history in tier-1 seconds) and on wall time in ``ClientApp``.  While
the recorder's history is still shorter than a window, burn math uses
the actually-covered span (an honest partial answer beats a silent
zero), and an objective whose signal has no observations at all scores
burn 0 — absence of traffic is not an incident.

Results are exported as ``bkw_slo_*`` gauges, joined into the client and
server ``/healthz`` tri-state via :func:`summary_from_registry` (the
``obs/invariants.py`` pattern), journaled as ``slo_breach`` events on
every status transition, and handed to the diagnosis hook so a breach
arrives with its evidence attached (obs/diagnose.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .. import defaults
from ..utils import clock as clockmod
from . import journal as obs_journal
from . import metrics as obs_metrics
from .invariants import (_LEVEL_STATUS, _STATUS_LEVEL, STATUS_DEGRADED,
                         STATUS_OK, STATUS_VIOLATED)

_KINDS = ("counter_rate", "ratio", "quantile", "gauge_below")

_G_BURN = obs_metrics.gauge(
    "bkw_slo_burn_rate",
    "Error-budget burn rate per objective and window (1.0 = exactly"
    " on budget)", ("objective", "window"))
_G_STATUS = obs_metrics.gauge(
    "bkw_slo_status",
    "Objective health: 0 ok, 1 degraded (slow burn), 2 violated (fast"
    " burn)", ("objective",))
_C_BREACHES = obs_metrics.counter(
    "bkw_slo_breaches_total",
    "Objective transitions into a worse status", ("objective",))
_C_EVALS = obs_metrics.counter(
    "bkw_slo_evaluations_total", "SLO evaluation sweeps completed")


class SLOError(ValueError):
    """Malformed catalog entry (bkwlint BKW007 catches these statically;
    this is the runtime backstop)."""


@dataclass(frozen=True)
class Objective:
    """One parsed catalog entry."""

    id: str
    kind: str
    family: str
    labels: Tuple[Tuple[str, str], ...] = ()
    budget: float = 0.01
    target: float = 0.0
    total_family: str = ""
    description: str = ""

    @staticmethod
    def from_entry(entry: dict) -> "Objective":
        oid = str(entry.get("id", ""))
        kind = str(entry.get("kind", ""))
        if not oid or kind not in _KINDS:
            raise SLOError(f"bad SLO entry {entry!r}")
        if kind == "ratio" and not entry.get("total_family"):
            raise SLOError(f"SLO {oid!r}: ratio needs total_family")
        budget = float(entry.get("budget", 0.01))
        if budget <= 0:
            raise SLOError(f"SLO {oid!r}: budget must be > 0")
        return Objective(
            id=oid, kind=kind, family=str(entry.get("family", "")),
            labels=tuple(sorted((str(k), str(v)) for k, v in
                                dict(entry.get("labels") or {}).items())),
            budget=budget, target=float(entry.get("target", 0.0)),
            total_family=str(entry.get("total_family", "")),
            description=str(entry.get("description", "")))


def parse_catalog(entries=None) -> List[Objective]:
    entries = defaults.SLO_CATALOG if entries is None else entries
    out = [Objective.from_entry(e) for e in entries]
    seen = set()
    for obj in out:
        if obj.id in seen:
            raise SLOError(f"duplicate SLO id {obj.id!r}")
        seen.add(obj.id)
    return out


@dataclass
class Breach:
    """One objective's transition into a worse status."""

    objective: str
    t: float
    status: str
    prev_status: str
    burns: Dict[str, float] = field(default_factory=dict)
    window_s: float = 0.0

    def to_dict(self) -> dict:
        return {"objective": self.objective, "t": round(self.t, 6),
                "status": self.status, "prev_status": self.prev_status,
                "burns": {k: round(v, 4) for k, v in self.burns.items()},
                "window_s": round(self.window_s, 3)}


def _win_tag(w: float) -> str:
    return f"{w:g}s"


class SLOMonitor:
    """Evaluates the objective catalog against a SeriesRecorder.

    ``windows`` is the pair-of-pairs ((fast_short, fast_long),
    (slow_short, slow_long)); the scenario harness shrinks it onto
    loopback seconds, the sim keeps the real spans on virtual time.
    ``on_breach`` (optional) receives each :class:`Breach` — the
    diagnosis hook.  ``client`` only tags journal lines so colocated
    test processes stay attributable.
    """

    def __init__(self, recorder, catalog=None, clock=None,
                 windows=None, fast_burn: Optional[float] = None,
                 slow_burn: Optional[float] = None,
                 on_breach: Optional[Callable] = None,
                 client: str = "main"):
        self.recorder = recorder
        self.catalog: List[Objective] = (
            catalog if catalog and isinstance(catalog[0], Objective)
            else parse_catalog(catalog))
        self.clock = clockmod.resolve(clock)
        self.windows = tuple(tuple(float(w) for w in pair) for pair in
                             (defaults.SLO_WINDOWS if windows is None
                              else windows))
        self.fast_burn = float(defaults.SLO_FAST_BURN
                               if fast_burn is None else fast_burn)
        self.slow_burn = float(defaults.SLO_SLOW_BURN
                               if slow_burn is None else slow_burn)
        self.on_breach = on_breach
        self.client = client
        self.status: Dict[str, str] = {o.id: STATUS_OK
                                       for o in self.catalog}
        self.breaches: List[Breach] = []
        self.last_burns: Dict[str, Dict[str, float]] = {}

    # --- bad-fraction derivation -------------------------------------------

    def _bad_fraction(self, obj: Objective,
                      window_s: float) -> Optional[float]:
        """The window's bad-event fraction, or None when the signal has
        nothing to judge (no traffic != an incident)."""
        rec = self.recorder
        labels = dict(obj.labels)
        keys = rec.family_keys(obj.family, labels)
        if obj.kind == "counter_rate":
            span = max((rec.span(k, window_s) for k in keys),
                       default=0.0)
            if span <= 0:
                return None
            bad = sum(rec.delta(k, window_s) for k in keys)
            return min(1.0, bad / span)
        if obj.kind == "ratio":
            total = sum(rec.delta(k, window_s) for k in
                        rec.family_keys(obj.total_family, {}))
            if total <= 0:
                return None
            bad = sum(rec.delta(k, window_s) for k in keys)
            return min(1.0, bad / total)
        if obj.kind == "quantile":
            over = cnt = 0.0
            for k in keys:
                win = rec.hist_window(k, window_s)
                if win is None:
                    continue
                bounds, per, n, _s = win
                if n <= 0:
                    continue
                cnt += n
                over += sum(c for b, c in zip(bounds, per[:-1])
                            if b > obj.target) + per[-1]
            if cnt <= 0:
                return None
            return over / cnt
        # gauge_below: fraction of window samples under the floor
        below = total = 0
        for k in keys:
            for _t, v in rec.points(k, window_s):
                total += 1
                if v < obj.target:
                    below += 1
        if total <= 0:
            return None
        return below / total

    # --- evaluation --------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> Dict[str, str]:
        """One sweep: burn per window per objective, status transitions,
        gauges, journal, breach hook.  Returns {objective: status}.

        ``now`` stamps breaches on ``clock.now()`` — the journal's time
        axis — so the explainer can window events against a breach."""
        now = self.clock.now() if now is None else float(now)
        _C_EVALS.inc()
        (fast_a, fast_b), (slow_a, slow_b) = self.windows
        for obj in self.catalog:
            burns: Dict[str, float] = {}
            for w in (fast_a, fast_b, slow_a, slow_b):
                frac = self._bad_fraction(obj, w)
                burns[_win_tag(w)] = 0.0 if frac is None \
                    else frac / obj.budget
                _G_BURN.set(burns[_win_tag(w)], objective=obj.id,
                            window=_win_tag(w))
            self.last_burns[obj.id] = burns
            fast_fired = (burns[_win_tag(fast_a)] >= self.fast_burn
                          and burns[_win_tag(fast_b)] >= self.fast_burn)
            slow_fired = (burns[_win_tag(slow_a)] >= self.slow_burn
                          and burns[_win_tag(slow_b)] >= self.slow_burn)
            status = (STATUS_VIOLATED if fast_fired
                      else STATUS_DEGRADED if slow_fired else STATUS_OK)
            prev = self.status[obj.id]
            self.status[obj.id] = status
            _G_STATUS.set(_STATUS_LEVEL[status], objective=obj.id)
            if _STATUS_LEVEL[status] > _STATUS_LEVEL[prev]:
                breach = Breach(objective=obj.id, t=now, status=status,
                                prev_status=prev, burns=dict(burns),
                                window_s=fast_b)
                self.breaches.append(breach)
                _C_BREACHES.inc(objective=obj.id)
                obs_journal.emit("slo_breach", client=self.client,
                                 **breach.to_dict())
                if self.on_breach is not None:
                    try:
                        self.on_breach(breach)
                    except Exception as e:  # diagnosis must not kill eval
                        obs_journal.emit("slo_diagnose_error",
                                         objective=obj.id,
                                         error=repr(e)[:200])
            elif _STATUS_LEVEL[status] < _STATUS_LEVEL[prev]:
                obs_journal.emit("slo_recovered", client=self.client,
                                 objective=obj.id, status=status,
                                 t=round(now, 6))
        return dict(self.status)

    # --- summaries ---------------------------------------------------------

    def summary(self) -> dict:
        level = max([_STATUS_LEVEL[s] for s in self.status.values()],
                    default=0)
        return {
            "status": _LEVEL_STATUS[level],
            "objectives": dict(sorted(self.status.items())),
            "breaches": len(self.breaches),
        }


def summary_from_registry() -> dict:
    """Cross-process SLO summary from the registry gauges — what
    ``/healthz`` reports without holding a monitor reference (the
    ``obs/invariants.py`` pattern).  All-ok / empty in a process where
    no monitor has evaluated yet."""
    objectives: Dict[str, str] = {}
    level = 0
    for series in _G_STATUS._snapshot_series():
        lv = int(series["value"])
        objectives[series["labels"].get("objective", "?")] = \
            _LEVEL_STATUS.get(lv, STATUS_VIOLATED)
        level = max(level, lv)
    breaches = 0
    fam = obs_metrics.registry().get("bkw_slo_breaches_total")
    if fam is not None:
        breaches = int(sum(s["value"] for s in fam._snapshot_series()))
    return {"status": _LEVEL_STATUS.get(level, STATUS_VIOLATED),
            "objectives": dict(sorted(objectives.items())),
            "breaches": breaches}


def join_status(*statuses: str) -> str:
    """Worst-of tri-state join (durability x SLO for /healthz)."""
    level = max((_STATUS_LEVEL.get(s, 2) for s in statuses), default=0)
    return _LEVEL_STATUS[level]
