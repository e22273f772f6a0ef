"""Backward-compat facade over :mod:`backuwup_tpu_torch.obs.trace`.

Counterpart of ``backuwup_tpu/utils/tracing.py``.

The original host-tracing module (SURVEY §5.1) grew into the unified
observability plane: spans now carry trace/span ids that propagate
across threads, tasks, and the wire, feed the ``bkw_span_seconds``
histogram, and journal their closes.  Everything here simply re-exports
the obs implementation so the dozens of ``from ..utils import tracing``
call sites (and external scripts) keep working unchanged:

* ``span``/``traced``/``report``/``reset``/``format_report`` — the flat
  ``{name: (calls, total_s)}`` aggregate table, still gated on
  ``BKW_TRACE=1`` / :func:`enable` exactly as before (the id/histogram/
  journal mechanics run regardless of the gate);
* ``device_profiler`` — the ``BKW_TRACE_DIR`` device-trace hook (the
  reference's ``jax_profiler``, here a ``torch.profiler`` trace).

New code should import :mod:`backuwup_tpu_torch.obs.trace` directly.
"""

from __future__ import annotations

from ..obs.trace import (  # noqa: F401  (re-exported API)
    bind,
    current,
    current_span_id,
    current_trace_id,
    device_profiler,
    enable,
    enabled,
    format_report,
    new_span_id,
    new_trace_id,
    report,
    reset,
    span,
    traced,
)

__all__ = [
    "bind", "current", "current_span_id", "current_trace_id",
    "device_profiler", "enable",
    "enabled", "format_report", "new_span_id",
    "new_trace_id", "report", "reset", "span", "traced",
]
