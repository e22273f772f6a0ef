"""Pipeline and tiered-dedup counters.

Counterpart of the counters of ``backuwup_tpu/obs/profile.py``: the
per-stage dispatch accounting and the tiered dedup families, under the
same metric names.  The reference's device timer (``dev_time``,
``dev_time_stage``) and per-backup report are not part of the port yet.

=========  =================================================================
stage      what counts as one dispatch
=========  =================================================================
index      one batched dedup classification per pack batch (the device
           table or the host blob-index pass), bytes = 32 per ref
           classified.
=========  =================================================================

The other stages (scan, select, gather, digest) are named so that the
reference's stage set stays valid here; the port's pipeline does not
count them yet.
"""

from __future__ import annotations

from . import metrics as _metrics

STAGES = ("scan", "select", "gather", "digest", "index")

_DISPATCH = _metrics.counter(
    "bkw_device_dispatch_total",
    "Pipeline dispatches by logical stage (a fused program counts once "
    "under every stage it implements)", labelnames=("stage",))
_STAGE_BYTES = _metrics.counter(
    "bkw_pipeline_stage_bytes_total",
    "Actual payload bytes processed per pipeline stage",
    labelnames=("stage",))
_STAGE_PADDED = _metrics.counter(
    "bkw_pipeline_stage_padded_bytes_total",
    "Bytes as dispatched per pipeline stage, tile/bucket padding "
    "included", labelnames=("stage",))
_PAD_EFFICIENCY = _metrics.gauge(
    "bkw_pipeline_pad_efficiency",
    "Cumulative actual/padded byte ratio per stage (1.0 = no padding "
    "waste)", labelnames=("stage",))

# Tiered dedup index families (dedupstore/): the hot/cold/host probe
# split, the promotion/demotion clock, and the device bytes of the hot
# fingerprint table.
TIER_PATHS = ("device", "cold", "host")

_TIER_PROBES = _metrics.counter(
    "bkw_tier_probes_total",
    "Tiered dedup probes by answering path (device = hot HBM table, "
    "cold = host LSM fall-through, host = authority fallback)",
    labelnames=("path",))
_TIER_HITS = _metrics.counter(
    "bkw_tier_hits_total",
    "Tiered dedup probe hits (key classified duplicate) by answering "
    "path", labelnames=("path",))
_TIER_PROMOTIONS = _metrics.counter(
    "bkw_tier_promotions_total",
    "Fingerprints promoted cold -> hot by the probe-frequency clock")
_TIER_DEMOTIONS = _metrics.counter(
    "bkw_tier_demotions_total",
    "Fingerprints demoted hot -> cold under the DEDUP_HBM_BUDGET_BYTES "
    "cap")
_TIER_HBM = _metrics.gauge(
    "bkw_tier_hbm_bytes",
    "Current HBM bytes held by the hot fingerprint table (slots x 20 "
    "bytes x mesh devices)")
_TIER_HBM_HIGH = _metrics.gauge(
    "bkw_tier_hbm_highwater_bytes",
    "Peak HBM bytes ever held by the hot fingerprint table")
_TIER_COLD_RUNS = _metrics.gauge(
    "bkw_tier_cold_runs",
    "Sorted immutable runs on disk in the cold fingerprint store")
_TIER_COLD_RECORDS = _metrics.gauge(
    "bkw_tier_cold_records",
    "Records across the cold store's runs + memtable (cross-run "
    "duplicates counted until compaction merges them)")
_TIER_COLD_COMMITS = _metrics.counter(
    "bkw_tier_cold_run_commits_total",
    "Durable cold-tier run commits by kind", labelnames=("kind",))


def dispatch(stage: str, count: int = 1, actual_bytes: int = 0,
             padded_bytes: int = 0) -> None:
    """Record ``count`` dispatches for ``stage`` (see the module table
    for what counts as one).  Cheap enough to be always on."""
    if stage not in STAGES:
        raise ValueError(f"unknown pipeline stage {stage!r}")
    _DISPATCH.inc(count, stage=stage)
    if actual_bytes:
        _STAGE_BYTES.inc(actual_bytes, stage=stage)
    if padded_bytes:
        _STAGE_PADDED.inc(padded_bytes, stage=stage)
        padded = _STAGE_PADDED.value(stage=stage)
        if padded > 0:
            _PAD_EFFICIENCY.set(
                _STAGE_BYTES.value(stage=stage) / padded, stage=stage)


# --- tiered dedup accounting (dedupstore/) -----------------------------------

def tier_probes(path: str, probes: int, hits: int = 0) -> None:
    """Record ``probes`` classify lanes answered on ``path`` (device /
    cold / host), ``hits`` of which classified duplicate."""
    if path not in TIER_PATHS:
        raise ValueError(f"unknown tier path {path!r}")
    if probes:
        _TIER_PROBES.inc(probes, path=path)
    if hits:
        _TIER_HITS.inc(hits, path=path)


def tier_promotions(n: int) -> None:
    if n:
        _TIER_PROMOTIONS.inc(n)


def tier_demotions(n: int) -> None:
    if n:
        _TIER_DEMOTIONS.inc(n)


def tier_hbm_bytes(table_bytes: int) -> None:
    """Set the hot-table device-bytes gauge; the high-water twin only
    rises."""
    _TIER_HBM.set(table_bytes)
    if table_bytes > _TIER_HBM_HIGH.value():
        _TIER_HBM_HIGH.set(table_bytes)


def tier_cold_state(runs: int, records: int) -> None:
    _TIER_COLD_RUNS.set(runs)
    _TIER_COLD_RECORDS.set(records)


def tier_cold_commit(kind: str) -> None:
    _TIER_COLD_COMMITS.inc(1, kind=kind)
