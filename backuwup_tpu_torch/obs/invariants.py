"""Live durability invariants: does the system's core promise hold NOW?

Counterpart of ``backuwup_tpu/obs/invariants.py``, copied so that the port
imports nothing of the JAX package.

The paper's promise is that randomly matched, mutually untrusting peers
keep each other's encrypted data restorable.  Every prior layer enforces
a piece of that promise (audits demote droppers, erasure survives k-of-n
loss, repair re-homes), but nothing could *state* whether it currently
holds.  :class:`InvariantMonitor` closes that gap: it sweeps the
verifier-side source of truth — the placements table, the blob index,
the audit ledger, and the demotion set in :mod:`backuwup_tpu_torch.store` —
and computes point-in-time durability facts:

* per-stripe clean-survivor count vs RS_K (degraded when shards are on
  lost peers but >= k clean survive; LOST when fewer than k survive and
  no whole replica is alive — the data is unrestorable right now);
* packfiles whose every holder is demoted or dark;
* repair debt: bytes sitting on lost peers that a repair round would
  re-home;
* orphaned placements (rows for packfiles the blob index no longer
  references — leaked storage on peers);
* audit-coverage age: how stale the oldest attestation over any
  placement-holding peer is.

Facts are published as ``bkw_durability_*`` gauges (labeled by client so
multi-client test processes don't fight over one series), summarized in
the server ``/healthz`` and the client status port, and accrued into
``bkw_durability_violation_seconds_total`` — the scorecard's headline
"how long was data actually at risk" number (scenario/scorecard.py).

A *lost* peer here is exactly the repair plane's definition
(:func:`lost_peers`, shared with ``engine._lost_peers``): audit-demoted,
or dark past ``defaults.PEER_DARK_DEADLINE_S``.  Health flips to
``degraded`` while every byte is still restorable — the operator (or the
scenario gate) hears about shrinking margin *before* it hits zero.

Stdlib-only, like the rest of the obs core.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .. import defaults
from . import journal as obs_journal
from . import metrics as obs_metrics
from ..utils import clock as clockmod

#: Health taxonomy, worst-first when comparing: every fact is either
#: fine, a shrinking safety margin, or a broken promise.
STATUS_OK = "ok"
STATUS_DEGRADED = "degraded"
STATUS_VIOLATED = "violated"
_STATUS_LEVEL = {STATUS_OK: 0, STATUS_DEGRADED: 1, STATUS_VIOLATED: 2}
_LEVEL_STATUS = {v: k for k, v in _STATUS_LEVEL.items()}

_LABELS = ("client",)
_G_STRIPES = obs_metrics.gauge(
    "bkw_durability_stripes_total",
    "Packfiles currently placed as erasure stripes", _LABELS)
_G_DEGRADED = obs_metrics.gauge(
    "bkw_durability_stripes_degraded",
    "Stripes with lost shards but >= RS_K clean survivors", _LABELS)
_G_LOST = obs_metrics.gauge(
    "bkw_durability_stripes_lost",
    "Stripes with < RS_K clean survivors and no live whole copy", _LABELS)
_G_UNRESTORABLE = obs_metrics.gauge(
    "bkw_durability_packfiles_unrestorable",
    "Packfiles (striped or whole) with no restorable copy", _LABELS)
_G_REPAIR_DEBT = obs_metrics.gauge(
    "bkw_durability_repair_debt_bytes",
    "Bytes placed on lost peers awaiting repair re-home", _LABELS)
_G_ORPHANED = obs_metrics.gauge(
    "bkw_durability_orphaned_placements",
    "Placement rows for packfiles the blob index no longer references",
    _LABELS)
_G_AUDIT_AGE = obs_metrics.gauge(
    "bkw_durability_audit_coverage_age_seconds",
    "Age of the stalest attestation over placement-holding peers", _LABELS)
_G_STATUS = obs_metrics.gauge(
    "bkw_durability_status",
    "Durability health: 0 ok, 1 degraded, 2 violated", _LABELS)
_C_VIOLATION_S = obs_metrics.counter(
    "bkw_durability_violation_seconds_total",
    "Monotonic-clock seconds spent with a durability invariant violated",
    _LABELS)
_C_SWEEPS = obs_metrics.counter(
    "bkw_durability_sweeps_total", "Invariant monitor sweeps", _LABELS)

#: Gauge handles by summary key, for :func:`summary_from_registry`.
_FACT_GAUGES = {
    "stripes_total": _G_STRIPES,
    "stripes_degraded": _G_DEGRADED,
    "stripes_lost": _G_LOST,
    "packfiles_unrestorable": _G_UNRESTORABLE,
    "repair_debt_bytes": _G_REPAIR_DEBT,
    "orphaned_placements": _G_ORPHANED,
}


def lost_peers(store, now: float) -> Set[bytes]:
    """Placement-holding peers considered LOST: audit-demoted, or dark
    (unseen) past ``defaults.PEER_DARK_DEADLINE_S``.  The single shared
    definition — the repair plane (``engine._lost_peers``) and the
    invariant monitor must never disagree about which peers count."""
    lost: Set[bytes] = set()
    for peer in store.peers_with_placements():
        peer = bytes(peer)
        if store.get_audit_state(peer).demoted:
            lost.add(peer)
            continue
        info = store.get_peer(peer)
        if info is not None and info.last_seen is not None and \
                now - info.last_seen > defaults.PEER_DARK_DEADLINE_S:
            lost.add(peer)
    return lost


@dataclass
class InvariantReport:
    """One sweep's durability facts (see module docstring for meaning)."""

    now: float
    stripes_total: int = 0
    stripes_degraded: int = 0
    stripes_lost: int = 0
    packfiles_total: int = 0
    packfiles_unrestorable: int = 0
    placements_total: int = 0
    lost_peer_count: int = 0
    repair_debt_bytes: int = 0
    orphaned_placements: int = 0
    audit_coverage_age_s: float = 0.0
    violations: List[str] = field(default_factory=list)
    degradations: List[str] = field(default_factory=list)

    @property
    def status(self) -> str:
        if self.violations:
            return STATUS_VIOLATED
        if self.degradations:
            return STATUS_DEGRADED
        return STATUS_OK

    @property
    def summary(self) -> dict:
        """The /healthz- and scorecard-facing view."""
        return {
            "status": self.status,
            "stripes_total": self.stripes_total,
            "stripes_degraded": self.stripes_degraded,
            "stripes_lost": self.stripes_lost,
            "packfiles_unrestorable": self.packfiles_unrestorable,
            "repair_debt_bytes": self.repair_debt_bytes,
            "orphaned_placements": self.orphaned_placements,
            "audit_coverage_age_s": round(self.audit_coverage_age_s, 3),
            "violations": list(self.violations),
            "degradations": list(self.degradations),
        }


class InvariantMonitor:
    """Sweeps one client's verifier-side state into durability facts.

    ``index`` (a :class:`~backuwup_tpu_torch.snapshot.blob_index.BlobIndex`,
    optional) enables the orphaned-placement check; without it that fact
    stays 0.  ``client`` labels the published series.  :meth:`sweep` is
    synchronous and cheap (one placements query + one ledger read per
    holder); :meth:`run` wraps it in a background cadence for
    ``ClientApp``.
    """

    def __init__(self, store, index=None, client: str = "main",
                 clock=None):
        self.store = store
        self.index = index
        self.client = client
        self.clock = clockmod.resolve(clock)
        self.last_report: Optional[InvariantReport] = None
        self._last_mono: Optional[float] = None

    # --- the sweep ---------------------------------------------------------

    def sweep(self, now: Optional[float] = None) -> InvariantReport:
        # ``now`` is wall-compatible (judged against persisted last_seen/
        # sent_at timestamps); the violation-seconds accrual interval is
        # measured on the monotonic clock so an NTP step can neither
        # inflate nor hide time-at-risk.  Callers that pin ``now`` (tests,
        # the sim) get it used for both — explicit virtual time IS the
        # monotonic axis there.
        mono = self.clock.monotonic() if now is None else now
        now = self.clock.now() if now is None else now
        rep = InvariantReport(now=now)
        rows = self.store.all_placements()
        lost = lost_peers(self.store, now)
        rep.placements_total = len(rows)
        rep.lost_peer_count = len(lost)

        by_pid: Dict[bytes, List[Tuple[bytes, int, int]]] = {}
        for pid, peer, size, shard_index, _sent_at in rows:
            by_pid.setdefault(pid, []).append((peer, size, shard_index))
        rep.packfiles_total = len(by_pid)

        k = defaults.RS_K
        n = defaults.RS_K + defaults.RS_M
        for pid, prows in sorted(by_pid.items()):
            tag = pid.hex()[:12]
            whole_alive = any(idx < 0 and peer not in lost
                              for peer, _s, idx in prows)
            lost_rows = sum(1 for peer, _s, _i in prows if peer in lost)
            rep.repair_debt_bytes += sum(
                size for peer, size, _i in prows if peer in lost)
            stripe_rows = [(peer, idx) for peer, _s, idx in prows
                           if idx >= 0]
            if stripe_rows:
                rep.stripes_total += 1
                # a re-striped packfile may have more than n rows while a
                # repair is mid-flight; judge against the wider of the two
                expected = max(n, max(idx for _p, idx in stripe_rows) + 1)
                clean = len({idx for peer, idx in stripe_rows
                             if peer not in lost})
                if whole_alive:
                    continue  # a live full replica trumps stripe math
                if clean < k and lost_rows:
                    rep.stripes_lost += 1
                    rep.packfiles_unrestorable += 1
                    rep.violations.append(
                        f"stripe {tag}: {clean}/{k} clean survivors"
                        " — unrestorable")
                elif clean < expected:
                    # either shards sit on lost peers (> k still clean)
                    # or the stripe is mid-upload: placements land
                    # per-ack, so a backup in flight is visibly short of
                    # coverage without any peer having been lost
                    rep.stripes_degraded += 1
                    why = "lost shard(s)" if lost_rows else "incomplete"
                    rep.degradations.append(
                        f"stripe {tag}: {clean}/{expected} clean shards"
                        f" ({why}; safe at >= {k})")
            elif not whole_alive and lost_rows:
                rep.packfiles_unrestorable += 1
                rep.violations.append(
                    f"packfile {tag}: every replica on a lost peer")

        if rep.repair_debt_bytes and not rep.violations:
            rep.degradations.append(
                f"{rep.repair_debt_bytes} bytes on lost peers await repair")

        # orphaned placements: rows whose packfile the blob index no
        # longer references (leaked peer storage, e.g. a forgotten repair)
        if self.index is not None and by_pid:
            try:
                live_pids = self.index.packfile_ids()
            except RuntimeError:  # index mutating concurrently; next sweep
                live_pids = None
            if live_pids:
                rep.orphaned_placements = sum(
                    len(prows) for pid, prows in by_pid.items()
                    if pid not in live_pids)
                if rep.orphaned_placements:
                    rep.degradations.append(
                        f"{rep.orphaned_placements} placement rows orphaned"
                        " by the blob index")

        # audit-coverage age: the stalest attestation across holders; a
        # never-audited holder counts from its first placement
        holders: Dict[bytes, float] = {}
        for _pid, peer, _size, _idx, sent_at in rows:
            holders[peer] = min(holders.get(peer, sent_at), sent_at)
        worst = 0.0
        for peer, first_sent in holders.items():
            st = self.store.get_audit_state(peer)
            basis = st.last_audit if st.last_audit else first_sent
            worst = max(worst, now - basis)
        rep.audit_coverage_age_s = max(0.0, worst)
        if rep.audit_coverage_age_s > defaults.DURABILITY_AUDIT_MAX_AGE_S:
            rep.degradations.append(
                f"stalest audit {rep.audit_coverage_age_s:.0f}s old"
                f" (> {defaults.DURABILITY_AUDIT_MAX_AGE_S:.0f}s)")

        self._publish(rep, mono)
        return rep

    def _publish(self, rep: InvariantReport, mono: float) -> None:
        c = self.client
        _G_STRIPES.set(rep.stripes_total, client=c)
        _G_DEGRADED.set(rep.stripes_degraded, client=c)
        _G_LOST.set(rep.stripes_lost, client=c)
        _G_UNRESTORABLE.set(rep.packfiles_unrestorable, client=c)
        _G_REPAIR_DEBT.set(rep.repair_debt_bytes, client=c)
        _G_ORPHANED.set(rep.orphaned_placements, client=c)
        _G_AUDIT_AGE.set(rep.audit_coverage_age_s, client=c)
        _G_STATUS.set(_STATUS_LEVEL[rep.status], client=c)
        _C_SWEEPS.inc(client=c)
        # violation time accrues over the interval the PREVIOUS sweep
        # proved violated — the first bad sweep starts the clock
        prev = self.last_report
        if prev is not None and self._last_mono is not None \
                and prev.status == STATUS_VIOLATED \
                and mono > self._last_mono:
            _C_VIOLATION_S.inc(mono - self._last_mono, client=c)
        if prev is None or prev.status != rep.status:
            obs_journal.emit("durability", client=c, status=rep.status,
                             stripes_degraded=rep.stripes_degraded,
                             stripes_lost=rep.stripes_lost,
                             unrestorable=rep.packfiles_unrestorable,
                             repair_debt_bytes=rep.repair_debt_bytes)
        self.last_report = rep
        self._last_mono = mono

    # --- background cadence ------------------------------------------------

    async def run(self, interval_s: Optional[float] = None,
                  janitor=None) -> None:
        """Sweep-then-sleep forever (cancel to stop); the ClientApp
        background task.  Sweeping FIRST makes health current within one
        interval of any state change.  ``janitor`` (a blocking callable,
        e.g. ``Engine.expire_partials``) piggybacks on the same cadence
        so receiver-side TTL hygiene runs on live processes too, not
        only inside startup recovery — it runs on the executor and its
        failures are contained like a sweep bug's."""
        interval = defaults.DURABILITY_SWEEP_INTERVAL_S \
            if interval_s is None else interval_s
        loop = asyncio.get_running_loop()
        while True:
            try:
                self.sweep()
            except Exception as e:  # a sweep bug must not kill the app
                obs_journal.emit("durability_sweep_error", client=self.client,
                                 error=repr(e)[:200])
            if janitor is not None:
                try:
                    await loop.run_in_executor(None, janitor)
                except Exception as e:
                    obs_journal.emit("durability_sweep_error",
                                     client=self.client,
                                     error=repr(e)[:200])
            await self.clock.sleep(interval)


def summary_from_registry() -> dict:
    """Cross-client durability summary from the process registry — what
    the coordination server's ``/healthz`` reports when clients are
    colocated (the scenario harness, tests, bench), and all zeros /
    ``ok`` in a standalone server process.  Counts sum across client
    labels; status and audit age take the worst."""
    out = {key: 0 for key in _FACT_GAUGES}
    level = 0
    age = 0.0
    for key, gauge in _FACT_GAUGES.items():
        for series in gauge._snapshot_series():
            out[key] += int(series["value"])
    for series in _G_STATUS._snapshot_series():
        level = max(level, int(series["value"]))
    for series in _G_AUDIT_AGE._snapshot_series():
        age = max(age, float(series["value"]))
    out["audit_coverage_age_s"] = round(age, 3)
    out["status"] = _LEVEL_STATUS.get(level, STATUS_VIOLATED)
    return out
