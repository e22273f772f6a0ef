"""Bounded in-process time series over the metrics registry.

Counterpart of ``backuwup_tpu/obs/series.py``, copied so that the port
imports nothing of the JAX package.

GWP's argument (PAPERS.md) is that regressions are findable only when
telemetry is *continuously* collected — a cumulative counter snapshot
says where the system is, never how it got there.  This module closes
that gap without an external TSDB: a :class:`SeriesRecorder` samples a
selected set of ``bkw_*`` registry families on a cadence into bounded
per-series ring buffers, and derives the windowed views the SLO plane
(obs/slo.py) and the breach explainer (obs/diagnose.py) need:

* ``delta``/``rate`` over a trailing window for counters (reset-safe:
  a shrinking cumulative value clamps to the post-reset tail instead of
  going negative);
* windowed per-bucket histogram deltas, so a p99 objective judges the
  window's OWN observations, not the process lifetime;
* robust-zscore anomaly flags (median/MAD — one outlier cannot drag the
  baseline the way a mean/stddev score lets it).

All time flows through the ``utils/clock.py`` seam: under ``SimDriver``
the recorder runs on virtual time and a simulated week of history costs
tier-1 seconds; in ``ClientApp``/server it runs on the wall clock.
bkwlint BKW006 enforces the seam statically.

Series are keyed ``family{label=value,...}`` — the same flat spelling
the scenario scorecard uses — so a key is printable evidence as-is.
Beyond registry sampling, :meth:`SeriesRecorder.record` appends
synthetic points directly; the sim plane uses it to chart world-truth
numbers (``sim:*`` keys) that never transit the registry.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from .. import defaults
from ..utils import clock as clockmod
from . import journal as obs_journal
from . import metrics as obs_metrics

_C_SAMPLES = obs_metrics.counter(
    "bkw_series_samples_total", "Recorder sampling sweeps completed")
_G_POINTS = obs_metrics.gauge(
    "bkw_series_points", "Retained time-series points per family",
    ("family",))

#: MAD == 0 means the baseline is perfectly flat; any deviation is then
#: "infinitely" surprising — capped so rankings stay comparable/sortable.
_Z_CAP = 99.0


def flat_key(family: str, labels: Dict[str, str]) -> str:
    """``family{label=value,...}`` with labels sorted — the one spelling
    shared with the scorecard's counter_deltas keys."""
    if not labels:
        return family
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{family}{{{inner}}}"


def robust_zscore(values: Sequence[float]) -> float:
    """Robust z of the LAST value against the median/MAD of the rest.

    z = 0.6745 * (x - median) / MAD, the standard consistency-scaled
    form; a flat baseline (MAD 0) maps any deviation to ±``_Z_CAP`` so
    deterministic ranking survives the degenerate case."""
    if len(values) < 2:
        return 0.0
    base = sorted(values[:-1])
    n = len(base)
    med = (base[n // 2] if n % 2 else
           (base[n // 2 - 1] + base[n // 2]) / 2.0)
    devs = sorted(abs(v - med) for v in base)
    mad = (devs[n // 2] if n % 2 else
           (devs[n // 2 - 1] + devs[n // 2]) / 2.0)
    x = values[-1]
    if mad <= 0.0:
        if x == med:
            return 0.0
        return _Z_CAP if x > med else -_Z_CAP
    z = 0.6745 * (x - med) / mad
    return max(-_Z_CAP, min(_Z_CAP, z))


class SeriesRecorder:
    """Ring-buffered history for selected registry families.

    ``families`` maps family name -> retention override (None keeps
    ``defaults.SERIES_RETENTION_POINTS``).  A plain sequence of names is
    accepted too.  Counters/gauges store ``(t, float)`` points;
    histograms store ``(t, (cum_counts, sum, count))`` where
    ``cum_counts`` is the cumulative per-bucket tuple in bound order
    plus +Inf — exactly what a windowed quantile needs to difference.
    """

    def __init__(self, families, registry=None, clock=None,
                 retention: Optional[int] = None,
                 journal_samples: bool = False):
        if not isinstance(families, dict):
            families = {name: None for name in families}
        self.registry = registry or obs_metrics.registry()
        self.clock = clockmod.resolve(clock)
        self.retention = int(defaults.SERIES_RETENTION_POINTS
                             if retention is None else retention)
        self.journal_samples = bool(journal_samples)
        self._retention: Dict[str, int] = {
            name: int(cap) if cap else self.retention
            for name, cap in families.items()}
        #: key -> deque[(t, value)]
        self._points: Dict[str, deque] = {}
        #: key -> "counter" | "gauge" | "histogram" (manual keys: caller-set)
        self.kinds: Dict[str, str] = {}
        #: key -> owning family (manual keys: the key itself)
        self._family_of: Dict[str, str] = {}
        self.samples_taken = 0

    # --- writing -----------------------------------------------------------

    def _append(self, key: str, family: str, kind: str, t: float,
                value) -> None:
        dq = self._points.get(key)
        if dq is None:
            cap = self._retention.get(family, self.retention)
            dq = self._points[key] = deque(maxlen=cap)
            self.kinds[key] = kind
            self._family_of[key] = family
        dq.append((t, value))

    def record(self, key: str, value: float, t: Optional[float] = None,
               kind: str = "gauge") -> None:
        """Manual point append for synthetic series (the sim plane's
        world-truth numbers).  ``key`` doubles as the family."""
        t = self.clock.monotonic() if t is None else float(t)
        self._append(key, key, kind, t, float(value))

    def sample(self) -> int:
        """One sweep over the selected families; returns points added."""
        t = self.clock.monotonic()
        snap_points = 0
        per_family: Dict[str, int] = {}
        for family in self._retention:
            fam = self.registry.get(family)
            if fam is None:
                continue
            kind = fam.kind
            for series in fam._snapshot_series():
                key = flat_key(family, series.get("labels", {}))
                if kind == "histogram":
                    buckets = series["buckets"]
                    cum = tuple(buckets[b] for b in
                                sorted((k for k in buckets if k != "+Inf"),
                                       key=float)) + (buckets["+Inf"],)
                    value = (cum, float(series.get("sum", 0.0)),
                             int(series.get("count", 0)))
                else:
                    value = float(series.get("value", 0.0))
                self._append(key, family, kind, t, value)
                snap_points += 1
                per_family[family] = per_family.get(family, 0) + 1
        self.samples_taken += 1
        _C_SAMPLES.inc()
        for family in per_family:
            retained = sum(len(dq) for k, dq in self._points.items()
                           if self._family_of[k] == family)
            _G_POINTS.set(retained, family=family)
        if self.journal_samples and snap_points:
            obs_journal.emit("series_sample", t=round(t, 6),
                            points=snap_points,
                            families=len(per_family))
        return snap_points

    # --- reading -----------------------------------------------------------

    def keys(self) -> List[str]:
        return sorted(self._points)

    def family_keys(self, family: str,
                    labels: Optional[Dict[str, str]] = None) -> List[str]:
        """Keys of one family whose labels contain ``labels`` (subset
        match on the flat spelling; {} matches every series)."""
        need = [f"{k}={v}" for k, v in (labels or {}).items()]
        out = []
        for key in sorted(self._points):
            if self._family_of[key] != family:
                continue
            inner = key[len(family):].strip("{}")
            parts = inner.split(",") if inner else []
            if all(n in parts for n in need):
                out.append(key)
        return out

    def points(self, key: str,
               window_s: Optional[float] = None) -> List[tuple]:
        dq = self._points.get(key)
        if not dq:
            return []
        if window_s is None:
            return list(dq)
        cutoff = dq[-1][0] - float(window_s)
        return [p for p in dq if p[0] >= cutoff]

    def latest(self, key: str):
        dq = self._points.get(key)
        return dq[-1] if dq else None

    def _window_pair(self, key: str, window_s: float):
        pts = self.points(key, window_s)
        if len(pts) < 2:
            return None
        return pts[0], pts[-1]

    def delta(self, key: str, window_s: float) -> float:
        """Counter increase over the window, reset-safe: a decrease
        (process restart / registry reset) restarts the accrual from the
        post-reset floor instead of reporting a negative burn."""
        pts = self.points(key, window_s)
        if len(pts) < 2:
            return 0.0
        total, prev = 0.0, pts[0][1]
        for _t, v in pts[1:]:
            step = v - prev
            if step > 0:
                total += step
            elif step < 0:  # reset: accrue from the post-reset floor
                total += v
            prev = v
        return total

    def rate(self, key: str, window_s: float) -> float:
        pair = self._window_pair(key, window_s)
        if pair is None:
            return 0.0
        span = pair[1][0] - pair[0][0]
        if span <= 0:
            return 0.0
        return self.delta(key, window_s) / span

    def span(self, key: str, window_s: float) -> float:
        """Clock seconds the window's points actually cover (<= window_s
        while history is still filling)."""
        pair = self._window_pair(key, window_s)
        return 0.0 if pair is None else pair[1][0] - pair[0][0]

    def hist_window(self, key: str, window_s: float):
        """(bounds, per-bucket counts, count, sum) of the histogram's
        observations inside the window — the delta of the cumulative
        views at the window's edges.  None without two points."""
        pair = self._window_pair(key, window_s)
        if pair is None or self.kinds.get(key) != "histogram":
            return None
        (_t0, (cum0, sum0, n0)), (_t1, (cum1, sum1, n1)) = pair
        if n1 < n0 or len(cum0) != len(cum1):
            cum0, sum0, n0 = (0,) * len(cum1), 0.0, 0  # reset mid-window
        per = []
        prev = 0
        for a, b in zip(cum0, cum1):
            d = b - a
            per.append(max(0, d - prev))
            prev = d
        fam = self.registry.get(self._family_of[key])
        bounds = tuple(getattr(fam, "bounds", ()))
        return bounds, per, n1 - n0, sum1 - sum0

    def fraction_over(self, key: str, window_s: float,
                      threshold: float) -> Optional[float]:
        """Fraction of the window's histogram observations in buckets
        whose upper bound exceeds ``threshold`` — the bad-event fraction
        of a latency objective.  None when the window holds nothing."""
        win = self.hist_window(key, window_s)
        if win is None:
            return None
        bounds, per, count, _sum = win
        if count <= 0:
            return None
        over = sum(c for bound, c in zip(bounds, per[:-1])
                   if bound > threshold) + per[-1]
        return over / count

    # --- anomaly flags -----------------------------------------------------

    def anomalies(self, window_s: float,
                  min_points: Optional[int] = None,
                  z_threshold: Optional[float] = None) -> List[dict]:
        """Robust-zscore flags over every series' window.

        Counters score consecutive increments (a level shift in the
        *rate* is the anomaly, not the ever-growing total); gauges score
        raw values; histograms score per-interval observation counts.
        Deterministic: scores rounded, sorted by (-|z|, key).
        """
        min_points = int(defaults.SERIES_ANOMALY_MIN_POINTS
                         if min_points is None else min_points)
        z_threshold = float(defaults.SERIES_ANOMALY_Z
                            if z_threshold is None else z_threshold)
        out = []
        for key in sorted(self._points):
            pts = self.points(key, window_s)
            kind = self.kinds.get(key, "gauge")
            if kind == "histogram":
                values = [p[1][2] for p in pts]
            else:
                values = [p[1] for p in pts]
            if kind in ("counter", "histogram"):
                values = [max(0.0, b - a)
                          for a, b in zip(values, values[1:])]
            if len(values) < min_points:
                continue
            z = robust_zscore(values)
            if abs(z) < z_threshold:
                continue
            out.append({"key": key, "kind": kind,
                        "z": round(z, 4),
                        "last": round(float(values[-1]), 6)})
        out.sort(key=lambda a: (-abs(a["z"]), a["key"]))
        return out

    # --- background cadence ------------------------------------------------

    async def run(self, interval_s: Optional[float] = None,
                  on_sample=None) -> None:
        """Sample-then-sleep forever (cancel to stop).  ``on_sample``
        (optional, zero-arg — the SLO monitor's evaluate) rides the same
        cadence; its failures are contained like a sweep bug's."""
        interval = (defaults.SERIES_SAMPLE_INTERVAL_S
                    if interval_s is None else interval_s)
        while True:
            try:
                self.sample()
                if on_sample is not None:
                    on_sample()
            except Exception as e:  # a recorder bug must not kill the app
                obs_journal.emit("series_sample_error",
                                error=repr(e)[:200])
            await self.clock.sleep(interval)
