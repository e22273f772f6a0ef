"""Observability plane of the port: metrics, traces, event journal.

Counterpart of the parts of ``backuwup_tpu/obs/`` that the backup data
plane and the network plane write to:

* :mod:`~backuwup_tpu_torch.obs.metrics` -- the process-wide registry of
  labeled counters, gauges and histograms (the same metric names);
* :mod:`~backuwup_tpu_torch.obs.trace` -- hierarchical spans
  (``utils/tracing.py`` re-exports them);
* :mod:`~backuwup_tpu_torch.obs.journal` -- the size-rotated JSONL event
  journal;
* :mod:`~backuwup_tpu_torch.obs.profile` -- the dispatch and tiered-dedup
  counters, the per-backup pipeline and overlap reports and the device
  timer;
* :mod:`~backuwup_tpu_torch.obs.invariants` -- the durability invariant
  monitor, whose ``bkw_durability_*`` facts ``/healthz`` reads;
* :mod:`~backuwup_tpu_torch.obs.timeline` -- journals and spans exported
  as Chrome trace-event JSON (Perfetto), several clients' journals merged
  into one timeline;
* :mod:`~backuwup_tpu_torch.obs.series`,
  :mod:`~backuwup_tpu_torch.obs.slo`,
  :mod:`~backuwup_tpu_torch.obs.diagnose` and
  :mod:`~backuwup_tpu_torch.obs.expo` -- the live SLO plane (series
  recorder, burn-rate status, breach diagnosis) and the ``/metrics`` +
  ``/healthz`` exposition of the server and the client, imported where
  they are used, as in the reference.

No module here imports ``torch`` when it is imported (``trace.device_profiler``
and ``profile.dev_time`` import it when called); ``expo`` imports
``aiohttp``.
"""

from . import invariants, journal, metrics, profile, timeline, trace

__all__ = ["invariants", "journal", "metrics", "profile", "timeline",
           "trace"]
