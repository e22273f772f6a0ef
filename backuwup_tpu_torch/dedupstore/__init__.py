"""Tiered dedup index: a device-hot probe over a host LSM cold tier.

Counterpart of ``backuwup_tpu/dedupstore/``.

``cold.py`` is the bucketed LSM-style host/disk fingerprint store
(sorted immutable runs + memtable, crash-disciplined run commits);
``tiered.py`` is the :class:`TieredDedupIndex` front that keeps the hot
:class:`~backuwup_tpu_torch.ops.dedup_index.ShardedDedupIndex` under the
``DEDUP_HBM_BUDGET_BYTES`` cap by demoting cold fingerprints instead of
growing 4x forever.  Architecture notes: docs/dedup_tiering.md (written
for the reference; the port keeps its design).
"""

from .cold import ColdFingerprintStore
from .tiered import TieredDedupIndex

__all__ = ["ColdFingerprintStore", "TieredDedupIndex"]
