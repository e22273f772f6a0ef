"""Device-pipeline profiler: dispatch accounting + honest stage timing.

Counterpart of ``backuwup_tpu/obs/profile.py``, a copy but for the device
timer: :func:`dev_time` times ``fn`` with CUDA events around its
launches when an argument is a CUDA tensor, and with
``time.perf_counter`` around the calls otherwise (the reference's
``_sync`` download trick is JAX's and has no counterpart here).  The
host path of the port's backends records every stage as the reference's
does; its device pipeline records none yet (ROADMAP §1 item 6).

The performance half of the obs plane (GWP, Ren et al. — PAPERS.md):
always-on, low-overhead counters wired into the pipeline entry points
in :mod:`backuwup_tpu_torch.ops.pipeline` /
:mod:`backuwup_tpu_torch.ops.backend`, plus the chained-execution device
timer.

Dispatch accounting semantics (the hand-countable contract the tests
pin; one *dispatch* = one device program launch, or its CPU-fallback
moral equivalent):

=========  =================================================================
stage      what counts as one dispatch
=========  =================================================================
scan       device: one fused ``scan_select_batch``/``scan_digest_batch``
           launch per batch.  CPU/native fallback: one ``chunk()`` pass
           per stream (native runs the whole pipeline in one C call per
           stream and counts once under every stage).
select     rides the scan program on every path (fused boundary
           selection), so it counts 1:1 with scan.
gather     device: one ``gather_chunks``/``_gather_digest`` tile launch.
           CPU fallback: one host piece-slicing pass per stream that
           produced at least one chunk.
digest     device: one batched digest launch (``_gather_digest`` tile,
           fused scan+digest batch, or ``blake3_many_tpu`` tiny-stream
           batch).  CPU fallback: one batched ``digest_many`` call per
           ``manifest_many``/stream segment with at least one piece.
index      one batched dedup classification per pack batch (device
           ``dedup_batch`` table classify or the host blob-index pass),
           bytes = 32 per ref classified.
=========  =================================================================

Bytes ride each dispatch twice: *actual* payload bytes and *padded*
bytes as dispatched (tile/bucket padding included), so
``bkw_pipeline_pad_efficiency`` exposes how much of every launch was
real work — the number PERF.md round-5 item 1 (merging the per-class
digest dispatches) moves.

Like the rest of ``obs/`` this module is import-light: stdlib +
defaults only; torch is imported lazily inside the timing helper.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from . import journal as _journal
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
_PROFILE_SECONDS = _metrics.histogram(
    "bkw_profile_stage_seconds",
    "Honest chained-execution device seconds per profiled stage "
    "(dev_time_stage)", labelnames=("stage",))

# Per-device twins of the dispatch/bytes/pad families for the mesh
# pipeline (shard_map over the row axis).  Additive alongside the
# unlabeled families above, PR-7 style (bkw_peer_transfer_* next to
# bkw_transfer_*): one shard_map launch still counts ONCE per stage in
# bkw_device_dispatch_total, and additionally once per participating
# device here — so the unlabeled families keep their hand-countable
# "one program launch" meaning while these expose the per-shard split.
_DISPATCH_DEV = _metrics.counter(
    "bkw_mesh_device_dispatch_total",
    "Mesh-pipeline dispatches by stage and participating device shard",
    labelnames=("stage", "device"))
_STAGE_BYTES_DEV = _metrics.counter(
    "bkw_mesh_stage_bytes_total",
    "Actual payload bytes per stage per device shard",
    labelnames=("stage", "device"))
_STAGE_PADDED_DEV = _metrics.counter(
    "bkw_mesh_stage_padded_bytes_total",
    "Bytes as dispatched per stage per device shard, padding included",
    labelnames=("stage", "device"))
_PAD_EFFICIENCY_DEV = _metrics.gauge(
    "bkw_mesh_pad_efficiency",
    "Cumulative actual/padded byte ratio per stage per device shard",
    labelnames=("stage", "device"))
_HBM_HIGH = _metrics.gauge(
    "bkw_mesh_hbm_highwater_bytes",
    "Peak bytes in flight per device across the mesh driver's dispatch "
    "window (buffers + packed cuts + digest accumulator + dedup lanes)",
    labelnames=("device",))

# Tiered dedup index families (dedupstore/, docs/dedup_tiering.md): the
# hot/cold/host probe split, the promotion/demotion clock, and the HBM
# footprint of the hot fingerprint table.  Declared here (not in
# dedupstore/) so every family has exactly one construction site and the
# report below can fold the tier split into the per-backup delta.
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

# Span names whose bkw_span_seconds sums a pipeline report attributes as
# per-stage wall time (the device pipeline's dispatch/collect pairs plus
# the packer entry point that drives them).
REPORT_SPANS = (
    "pipeline.scan_select_dispatch",
    "pipeline.cut_collect",
    "pipeline.digest_dispatch",
    "pipeline.digest_collect",
    "pipeline.scan_digest_dispatch",
    "pipeline.scan_digest_collect",
    "pipeline.mesh_dispatch",
    "pipeline.mesh_collect",
    "pipeline.h2d_stage",
    "packer.manifest_many",
)

# Streaming-dataflow overlap families (the engine's stage graph,
# docs/dataflow.md): per-stage busy seconds attributed to one backup at
# end of run, plus the overlap-efficiency verdict the bench
# `20_dataflow` gate watches.  Declared here — the single construction
# site for every bkw_* family — and folded by :func:`overlap_report`.
_BACKUP_STAGE_BUSY = _metrics.counter(
    "bkw_backup_stage_busy_seconds_total",
    "Busy seconds per backup dataflow stage (chunk_hash / seal / write /"
    " send), attributed per run from the stage-seconds registry deltas",
    labelnames=("stage",))
_BACKUP_OVERLAP = _metrics.gauge(
    "bkw_backup_overlap_efficiency",
    "max(per-stage busy seconds) / end-to-end wall for the most recent"
    " backup; 1.0 means the wall clock converged to the slowest stage")


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


def dispatch_device(stage: str, device: int, count: int = 1,
                    actual_bytes: int = 0, padded_bytes: int = 0) -> None:
    """Record one device shard's share of a mesh launch.

    Touches ONLY the per-device families — the caller records the launch
    itself once via :func:`dispatch`, so ``bkw_device_dispatch_total``
    stays the hand-countable program-launch count and
    ``bkw_mesh_device_dispatch_total`` sums to launches x mesh size."""
    if stage not in STAGES:
        raise ValueError(f"unknown pipeline stage {stage!r}")
    dev = str(device)
    _DISPATCH_DEV.inc(count, stage=stage, device=dev)
    if actual_bytes:
        _STAGE_BYTES_DEV.inc(actual_bytes, stage=stage, device=dev)
    if padded_bytes:
        _STAGE_PADDED_DEV.inc(padded_bytes, stage=stage, device=dev)
        padded = _STAGE_PADDED_DEV.value(stage=stage, device=dev)
        if padded > 0:
            _PAD_EFFICIENCY_DEV.set(
                _STAGE_BYTES_DEV.value(stage=stage, device=dev) / padded,
                stage=stage, device=dev)


def hbm_high_water(device: int, in_flight_bytes: int) -> None:
    """Raise (never lower) the per-device HBM high-water gauge."""
    dev = str(device)
    cur = _HBM_HIGH.value(device=dev)
    if in_flight_bytes > cur:
        _HBM_HIGH.set(in_flight_bytes, device=dev)


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
    """Set the hot-table HBM gauge; the high-water twin only rises."""
    _TIER_HBM.set(table_bytes)
    if table_bytes > _TIER_HBM_HIGH.value():
        _TIER_HBM_HIGH.set(table_bytes)


def tier_cold_state(runs: int, records: int) -> None:
    _TIER_COLD_RUNS.set(runs)
    _TIER_COLD_RECORDS.set(records)


def tier_cold_commit(kind: str) -> None:
    _TIER_COLD_COMMITS.inc(1, kind=kind)


# --- honest device timing ---------------------------------------------------

def _cuda_device(args):
    """The device of the first CUDA tensor among ``args``, else None."""
    for a in args:
        dev = getattr(a, "device", None)
        if getattr(dev, "type", None) == "cuda":
            return dev
    return None


def dev_time(fn, *args, n: int = 20) -> float:
    """Honest per-call device seconds for ``fn(*args)``.

    One warm-up call, then ``n`` chained calls, averaged.  When an
    argument is a CUDA tensor the time is read from CUDA events recorded
    before and after the ``n`` launches on the current stream (dispatch
    overhead amortises; the host clock never sees the device); otherwise
    ``time.perf_counter`` brackets the ``n`` calls."""
    dev = _cuda_device(args)
    if dev is None:
        fn(*args)
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        return max(time.perf_counter() - t0, 1e-9) / n
    import torch

    with torch.cuda.device(dev):
        fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(*args)
        end.record()
        end.synchronize()
        return max(start.elapsed_time(end) / 1e3, 1e-9) / n


def dev_time_stage(stage: str, fn, *args, n: int = 20) -> float:
    """:func:`dev_time` with the registry as sink: observes the result
    into ``bkw_profile_stage_seconds{stage}`` and journals a ``profile``
    event so one-off probe runs leave a durable record."""
    dt = dev_time(fn, *args, n=n)
    _PROFILE_SECONDS.observe(dt, stage=stage)
    _journal.emit("profile", stage=stage, dev_s=round(dt, 9), n=n)
    return dt


# --- per-backup pipeline report ---------------------------------------------

def _device_values(fam) -> Dict[tuple, float]:
    """{(device, stage): value} for one (stage, device)-labeled family."""
    return {(s["labels"]["device"], s["labels"]["stage"]): s["value"]
            for s in fam._snapshot_series()}


def baseline() -> Dict[str, Dict[str, float]]:
    """Snapshot the profiler families so :func:`report` can attribute a
    delta to one backup (the engine's ``_registry_stage_sums`` idiom)."""
    out = {"dispatch": {}, "bytes": {}, "padded": {}, "span_s": {},
           "dispatch_dev": _device_values(_DISPATCH_DEV),
           "bytes_dev": _device_values(_STAGE_BYTES_DEV),
           "padded_dev": _device_values(_STAGE_PADDED_DEV)}
    for stage in STAGES:
        out["dispatch"][stage] = _DISPATCH.value(stage=stage)
        out["bytes"][stage] = _STAGE_BYTES.value(stage=stage)
        out["padded"][stage] = _STAGE_PADDED.value(stage=stage)
    tier: Dict[str, float] = {"promotions": _TIER_PROMOTIONS.value(),
                              "demotions": _TIER_DEMOTIONS.value()}
    for path in TIER_PATHS:
        tier[f"probes_{path}"] = _TIER_PROBES.value(path=path)
        tier[f"hits_{path}"] = _TIER_HITS.value(path=path)
    out["tier"] = tier
    spans = _metrics.registry().get("bkw_span_seconds")
    if spans is not None:
        for name in REPORT_SPANS:
            out["span_s"][name] = spans.sum_value(name=name)
    return out


def report(base: Optional[dict] = None) -> dict:
    """Dispatch counts, bytes, padding efficiency, and stage seconds
    since ``base`` (or process start when ``base`` is None)."""
    now = baseline()
    base = base or {}

    def _delta(section: str) -> Dict[str, float]:
        prior = base.get(section, {})
        return {k: v - prior.get(k, 0.0) for k, v in now[section].items()}

    dispatches = {k: int(v) for k, v in _delta("dispatch").items()}
    actual = {k: int(v) for k, v in _delta("bytes").items()}
    padded = {k: int(v) for k, v in _delta("padded").items()}
    efficiency = {
        stage: (round(actual[stage] / padded[stage], 6)
                if padded[stage] > 0 else None)
        for stage in STAGES}
    stage_seconds = {name: round(dt, 6)
                     for name, dt in _delta("span_s").items() if dt > 0}
    # per-device split of the mesh-pipeline launches: {device: {stage: n}}
    # plus per-device pad efficiency, so the report shows whether work
    # divided evenly across the shards (the bench even-split gate)
    by_device: Dict[str, Dict[str, int]] = {}
    eff_device: Dict[str, Dict[str, Optional[float]]] = {}
    prior_d = base.get("dispatch_dev", {})
    now_d = now["dispatch_dev"]
    for (dev, stage), v in now_d.items():
        n = int(v - prior_d.get((dev, stage), 0.0))
        if n:
            by_device.setdefault(dev, {})[stage] = n
    prior_b, prior_p = base.get("bytes_dev", {}), base.get("padded_dev", {})
    for (dev, stage), v in now["padded_dev"].items():
        dp = v - prior_p.get((dev, stage), 0.0)
        if dp > 0:
            db = now["bytes_dev"].get((dev, stage), 0.0) \
                - prior_b.get((dev, stage), 0.0)
            eff_device.setdefault(dev, {})[stage] = round(db / dp, 6)
    out = {
        "dispatches": dispatches,
        "bytes": actual,
        "padded_bytes": padded,
        "pad_efficiency": efficiency,
        "stage_seconds": stage_seconds,
    }
    # tiered-dedup rows: probe/hit split per answering path plus the
    # promotion/demotion clock movement, only when the tier moved at all
    tier_delta = {k: int(v) for k, v in _delta("tier").items()}
    if any(tier_delta.values()):
        probes = {p: tier_delta[f"probes_{p}"] for p in TIER_PATHS}
        hits = {p: tier_delta[f"hits_{p}"] for p in TIER_PATHS}
        out["tier"] = {
            "probes": probes,
            "hits": hits,
            "promotions": tier_delta["promotions"],
            "demotions": tier_delta["demotions"],
            "device_hit_rate": (round(hits["device"] / probes["device"], 6)
                                if probes["device"] > 0 else None),
            "hbm_highwater_bytes": int(_TIER_HBM_HIGH.value()),
        }
    if by_device:
        out["device_dispatches"] = {
            d: by_device[d] for d in sorted(by_device, key=int)}
        out["device_pad_efficiency"] = {
            d: eff_device.get(d, {}) for d in sorted(by_device, key=int)}
    return out


def emit_report(rep: dict, **fields) -> None:
    """Journal one ``pipeline_report`` event (no-op without a journal,
    like every obs emission)."""
    _journal.emit("pipeline_report", report=rep, **fields)


def overlap_report(stage_busy: Dict[str, float], wall_s: float,
                   mode: str = "stream") -> dict:
    """Fold one backup's per-stage busy seconds into the overlap
    families and return the summary row the engine stores + journals.

    ``stage_busy`` must hold BUSY stages only — the caller excludes
    idle/wait accumulators (pack stall, transfer admission wait), which
    would otherwise reward a stalled pipeline.  Efficiency is
    max(stage)/wall: 1.0 means the end-to-end wall clock collapsed onto
    the slowest stage (perfect overlap); a phased run trends toward
    max/sum.  Concurrent fan-out can legitimately push a stage's summed
    busy seconds past the wall, so values above 1.0 are kept as-is."""
    busy = {k: max(float(v), 0.0) for k, v in stage_busy.items()}
    for stage, dt in busy.items():
        if dt > 0:
            _BACKUP_STAGE_BUSY.inc(dt, stage=stage)
    max_stage = max(busy.values(), default=0.0)
    eff = (max_stage / wall_s) if wall_s > 0 else 0.0
    _BACKUP_OVERLAP.set(eff)
    rep = {
        "mode": mode,
        "wall_s": round(wall_s, 6),
        "stage_busy_s": {k: round(v, 6) for k, v in busy.items()},
        "max_stage_s": round(max_stage, 6),
        "overlap_efficiency": round(eff, 6),
    }
    _journal.emit("overlap_report", **rep)
    return rep
