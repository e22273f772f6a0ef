"""Observability plane of the port: metrics, traces, event journal.

Counterpart of the parts of ``backuwup_tpu/obs/`` that the backup data
plane writes to:

* :mod:`~backuwup_tpu_torch.obs.metrics` -- the process-wide registry of
  labeled counters, gauges and histograms (the same metric names);
* :mod:`~backuwup_tpu_torch.obs.trace` -- hierarchical spans
  (``utils/tracing.py`` re-exports them);
* :mod:`~backuwup_tpu_torch.obs.journal` -- the size-rotated JSONL event
  journal;
* :mod:`~backuwup_tpu_torch.obs.profile` -- the dispatch and tiered-dedup
  counters.

Stdlib only: no module here imports ``torch``.
"""

from . import journal, metrics, profile, trace

__all__ = ["journal", "metrics", "profile", "trace"]
