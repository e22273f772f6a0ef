"""Process-wide metrics registry: labeled counters, gauges, histograms.

Counterpart of ``backuwup_tpu/obs/metrics.py``, copied so that the port imports
nothing of the JAX package; what it writes is byte-identical.

A deliberately small re-implementation of the Prometheus client data
model (the container bakes no ``prometheus_client`` wheel, and the
framework needs only a fraction of it):

* **Families are get-or-create.**  ``counter("bkw_x", ...)`` returns the
  existing family when one is already registered under that name, so
  every module can declare the metrics it touches at import time without
  coordinating import order; a name collision with a *different* type or
  label set is a programming error and raises :class:`MetricError`.
* **Thread-safe by construction.**  Every family guards its series map
  with one lock; producers on the packer thread, the seal workers, and
  the event loop can all increment concurrently and the totals are
  exact (covered by the threaded test in tests/test_obs.py).
* **Two read paths.**  :meth:`Registry.render_prometheus` emits the
  text exposition format (``# HELP``/``# TYPE`` + samples, histograms
  as cumulative ``_bucket``/``_sum``/``_count``) for ``GET /metrics``;
  :meth:`Registry.snapshot` returns a plain-JSON dict for bench records,
  panic dumps, and ``scripts/obs_dump.py``.

Histograms are log-bucketed (:func:`log_buckets`): stage times in this
system span ~1 ms device dispatches to ~30 s transfer stalls, a range a
linear bucket layout cannot cover with a fixed bucket count.

The metric name catalog lives in docs/observability.md.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class MetricError(ValueError):
    """Metric misuse: bad name, label mismatch, or type collision."""


def log_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` geometrically spaced upper bounds from ``start``
    (values rounded to 9 significant digits so renderings are stable)."""
    if start <= 0 or factor <= 1.0 or count < 1:
        raise MetricError("log_buckets needs start>0, factor>1, count>=1")
    return tuple(float(f"{start * factor ** i:.9g}") for i in range(count))


#: Default histogram layout for stage times: 1 ms .. ~32.8 s, doubling.
DEFAULT_SECONDS_BUCKETS = log_buckets(0.001, 2.0, 16)


def quantile_from_buckets(bounds: Sequence[float],
                          counts: Sequence[int], q: float) -> float:
    """Estimate the ``q``-quantile of a bucketed histogram.

    ``counts`` are *per-bucket* observation counts aligned with
    ``bounds`` plus one trailing overflow bucket (the internal
    :class:`Histogram` layout, NOT the cumulative exposition view).
    Within the located bucket the estimate interpolates geometrically
    (log-linear), matching the :func:`log_buckets` layout; the first
    bucket (lower edge 0) interpolates linearly.  Observations past the
    last bound clamp to it — the honest answer a bounded layout can
    give.  An empty histogram or an out-of-range ``q`` returns NaN.
    """
    total = sum(counts)
    if total <= 0 or not 0.0 <= q <= 1.0:
        return math.nan
    rank = q * total
    cum = 0
    for i, c in enumerate(counts[:-1]):
        prev = cum
        cum += c
        if cum >= rank and c > 0:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = float(bounds[i])
            frac = (rank - prev) / c
            if lo > 0.0:
                return lo * (hi / lo) ** frac
            return hi * frac
    return float(bounds[-1])


def _fmt(v: float) -> str:
    """Prometheus sample-value formatting (integers without the .0)."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


class _Family:
    """One named metric family: fixed label names, many labeled series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise MetricError(f"bad metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise MetricError(f"bad label name {ln!r} on {name}")
        self.name = name
        self.help = help
        self.labelnames: Tuple[str, ...] = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        # hot path (every inc/observe): every declared label present and
        # no extras — checked without building throwaway sets
        try:
            key = tuple(str(labels[ln]) for ln in self.labelnames)
        except KeyError:
            key = None
        if key is None or len(labels) != len(self.labelnames):
            raise MetricError(
                f"{self.name} expects labels {self.labelnames},"
                f" got {tuple(sorted(labels))}")
        return key

    def _label_str(self, key: Tuple[str, ...],
                   extra: Optional[Tuple[str, str]] = None) -> str:
        pairs = [f'{ln}="{_escape_label(lv)}"'
                 for ln, lv in zip(self.labelnames, key)]
        if extra is not None:
            pairs.append(f'{extra[0]}="{_escape_label(extra[1])}"')
        return "{" + ",".join(pairs) + "}" if pairs else ""

    def clear(self) -> None:
        with self._lock:
            self._series.clear()

    # subclasses implement:
    def _render_samples(self, out: List[str]) -> None:
        raise NotImplementedError

    def _snapshot_series(self) -> List[dict]:
        raise NotImplementedError


class Counter(_Family):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise MetricError(f"counter {self.name} cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._series.get(key, 0.0))

    def _render_samples(self, out: List[str]) -> None:
        with self._lock:
            items = sorted(self._series.items())
        for key, v in items:
            out.append(f"{self.name}{self._label_str(key)} {_fmt(v)}")

    def _snapshot_series(self) -> List[dict]:
        with self._lock:
            items = sorted(self._series.items())
        return [{"labels": dict(zip(self.labelnames, key)), "value": float(v)}
                for key, v in items]


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help, labelnames)
        bounds = tuple(sorted(float(b) for b in
                              (DEFAULT_SECONDS_BUCKETS if buckets is None
                               else buckets)))
        if not bounds or len(set(bounds)) != len(bounds):
            raise MetricError(f"histogram {name}: bad bucket bounds")
        if bounds and bounds[-1] == math.inf:
            bounds = bounds[:-1]  # +Inf is implicit
        self.bounds = bounds

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        v = float(value)
        i = bisect.bisect_left(self.bounds, v)  # first bound with v <= le
        with self._lock:
            state = self._series.get(key)
            if state is None:
                state = self._series[key] = \
                    [[0] * (len(self.bounds) + 1), 0.0]
            state[0][i] += 1
            state[1] += v

    def sum_value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            state = self._series.get(key)
            return float(state[1]) if state else 0.0

    def count_value(self, **labels) -> int:
        key = self._key(labels)
        with self._lock:
            state = self._series.get(key)
            return sum(state[0]) if state else 0

    def quantile(self, q: float, **labels) -> float:
        """Estimated ``q``-quantile for one labeled series (NaN when the
        series has no observations) — see :func:`quantile_from_buckets`."""
        key = self._key(labels)
        with self._lock:
            state = self._series.get(key)
            counts = list(state[0]) if state else None
        if counts is None:
            return math.nan
        return quantile_from_buckets(self.bounds, counts, q)

    def bucket_counts(self, **labels) -> Dict[str, int]:
        """Cumulative per-``le`` counts (the exposition view)."""
        key = self._key(labels)
        with self._lock:
            state = self._series.get(key)
            counts = list(state[0]) if state else [0] * (len(self.bounds) + 1)
        out, running = {}, 0
        for bound, c in zip(self.bounds, counts):
            running += c
            out[_fmt(bound)] = running
        out["+Inf"] = running + counts[-1]
        return out

    def _render_samples(self, out: List[str]) -> None:
        with self._lock:
            items = sorted((k, (list(s[0]), s[1]))
                           for k, s in self._series.items())
        for key, (counts, total) in items:
            running = 0
            for bound, c in zip(self.bounds, counts):
                running += c
                out.append(f"{self.name}_bucket"
                           f"{self._label_str(key, ('le', _fmt(bound)))}"
                           f" {running}")
            running += counts[-1]
            out.append(f"{self.name}_bucket"
                       f"{self._label_str(key, ('le', '+Inf'))} {running}")
            out.append(f"{self.name}_sum{self._label_str(key)} {_fmt(total)}")
            out.append(f"{self.name}_count{self._label_str(key)} {running}")

    def _snapshot_series(self) -> List[dict]:
        with self._lock:
            items = sorted((k, (list(s[0]), s[1]))
                           for k, s in self._series.items())
        out = []
        for key, (counts, total) in items:
            buckets, running = {}, 0
            for bound, c in zip(self.bounds, counts):
                running += c
                buckets[_fmt(bound)] = running
            buckets["+Inf"] = running + counts[-1]
            out.append({"labels": dict(zip(self.labelnames, key)),
                        "sum": float(total), "count": buckets["+Inf"],
                        "buckets": buckets})
        return out


class Registry:
    """Get-or-create store of metric families; the process global lives
    in :data:`_REGISTRY` (:func:`registry`)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}

    def _get_or_make(self, cls, name: str, help: str,
                     labelnames: Sequence[str], **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls \
                        or fam.labelnames != tuple(labelnames):
                    raise MetricError(
                        f"metric {name} already registered as"
                        f" {fam.kind}{fam.labelnames}")
                return fam
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_make(Histogram, name, help, labelnames,
                                 buckets=buckets)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def render_prometheus(self) -> str:
        """The text exposition format, families sorted by name."""
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        out: List[str] = []
        for fam in fams:
            if fam.help:
                out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            fam._render_samples(out)
        return "\n".join(out) + "\n" if out else ""

    def snapshot(self) -> dict:
        """Plain-JSON view: {name: {type, help, labels, series}}."""
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        return {fam.name: {"type": fam.kind, "help": fam.help,
                           "labels": list(fam.labelnames),
                           "series": fam._snapshot_series()}
                for fam in fams}

    def reset(self) -> None:
        """Zero every series but keep families registered (module-level
        handles stay valid) — the test-isolation hook."""
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            fam.clear()


#: The process-wide registry every subsystem instruments into.
_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY


def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return _REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "",
          labelnames: Sequence[str] = ()) -> Gauge:
    return _REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return _REGISTRY.histogram(name, help, labelnames, buckets)
