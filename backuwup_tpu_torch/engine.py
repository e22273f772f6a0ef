"""Backup/restore engine: orchestration of pack ∥ send ∥ progress.

Counterpart of ``backuwup_tpu/engine.py``: a copy (its relative imports
resolve in the port), apart from two seams.

* **The device dedup front.**  The reference builds its front on a JAX
  mesh (``dedup_mesh``, ``_default_mesh``) when ``backend.name ==
  "tpu"``.  Here the keyword is ``dedup_device`` (a torch device, or
  None), and the front is attached by default when ``backend.name ==
  "gpu"``, on the backend's own device (``GpuBackend.device``): a
  ``TieredDedupIndex`` (or, with ``BKW_DEDUP_TIERED=0``, the grow-only
  ``MeshDedupIndex``) of one shard.  ``BKW_DEVICE_DEDUP=0`` attaches
  none.  A repair rebuilds it on the same device with the same shard
  count.  The ``attach_mesh`` hook passes the device and the shard count
  where the reference passes the mesh and its axis; no port backend has
  that hook yet.
* **The device trace hook.**  The pack thread runs under
  ``tracing.device_profiler`` (a ``torch.profiler`` Chrome trace under
  ``$BKW_TRACE_DIR``) where the reference runs ``tracing.jax_profiler``.

With ``backend=None`` the engine takes ``select_backend()``, the
``GpuBackend`` on the card, which raises without CUDA.  Apart from the
two seams only docstrings and comments differ.

Re-designs ``client/src/backup/mod.rs`` + ``backup_orchestrator.rs`` +
``send.rs`` on asyncio:

* ``run_backup`` runs the packer (thread executor — chunking may drive the
  device) **concurrently** with the send loop, coupled by pause/resume
  backpressure on the local packfile buffer: packing pauses when unsent
  packfiles exceed 100 MiB, resumes below 50 MiB free
  (``defaults.rs:38,59``, ``backup_orchestrator.rs:81-113``).
* The send loop acquires peers: reuse the active transport, else dial known
  peers most-free-storage-first, else issue a storage request and wait for
  a match (``send.rs:209-262``); request sizing is
  ``estimate − fulfilled`` clamped to [50 MB step, 150 MB cap]
  (``send.rs:359-369``).
* Packfiles are deleted locally only after the peer's signed ack
  (``send.rs:277-289``); encrypted index files follow once packing
  completes, watermarked by ``highest_sent_index`` so re-runs resume
  (``send.rs:135-176``, ``config/backup.rs:80-98``).
* ``run_restore`` asks the server for the latest snapshot + negotiated
  peers, pulls everything back over RESTORE_ALL transports, rebuilds the
  blob index from the restored index files, and unpacks byte-identically
  (``backup/mod.rs:130-192``).
"""

from __future__ import annotations

import asyncio
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, Optional

from . import defaults, wire
from .audit import (
    AuditResult,
    build_challenge_table,
    check_proofs,
    record_fail,
    record_miss,
    record_pass,
    select_challenges,
)
from .crypto import KeyManager
# imported at module scope so the cold tier's crash sites register with
# the live faults registry the moment the engine is importable (the
# BKW003 static/live registry parity check depends on it)
from .dedupstore import TieredDedupIndex
from .erasure import gf_cpu
from .erasure import stripe as rs_stripe
from .net.client import NoBackups, ServerClient, ServerError
from .net.p2p import (
    P2PError,
    P2PNode,
    PartialStore,
    Receiver,
    RestoreFilesWriter,
    SendProgress,
    Transport,
    adaptive_deadline,
)
from .net.peer_stats import PeerStats
from .net.transfer import BYTES_RESENT, RESTORE_SOURCES, TransferScheduler
from .obs import invariants as obs_invariants
from .obs import journal as obs_journal
from .obs import metrics as obs_metrics
from .obs import profile as obs_profile
from .obs import trace as obs_trace
from .ops.backend import ChunkerBackend, select_backend
from .snapshot.blob_index import BlobIndex, ChallengeTable
from .snapshot.packer import DirPacker
from .snapshot.packfile import PackfileReader, PackfileWriter, packfile_path
from .store import (EVENT_BACKUP, EVENT_GC, EVENT_REPAIR,
                    EVENT_RESTORE_REQUEST, Store)
from .utils import faults, retry, tracing


class EngineError(Exception):
    pass


_BACKUP_RUNS = obs_metrics.counter(
    "bkw_backup_runs_total", "Backup runs by outcome", ("outcome",))
_RESTORE_RUNS = obs_metrics.counter(
    "bkw_restore_runs_total", "Restore runs by outcome", ("outcome",))
_AUDIT_ROUNDS = obs_metrics.counter(
    "bkw_audit_rounds_total", "Audit rounds run")
_REPAIR_ROUNDS = obs_metrics.counter(
    "bkw_repair_rounds_total", "Peer-loss repair rounds run")
_SHARDS_REBUILT = obs_metrics.counter(
    "bkw_repair_shards_rebuilt_total",
    "Erasure shards rebuilt sourcelessly and re-homed")
_BUSY_REJECTS = obs_metrics.counter(
    "bkw_engine_busy_rejections_total",
    "Backup/restore/repair attempts rejected while the engine was busy",
    ("op",))
_RECOVERY_RUNS = obs_metrics.counter(
    "bkw_recovery_runs_total", "Startup recovery sweeps run")
_RECOVERY_ITEMS = obs_metrics.counter(
    "bkw_recovery_items_total",
    "Items reconciled by the startup recovery sweep", ("category",))
_RECOVERY_SECONDS = obs_metrics.histogram(
    "bkw_recovery_seconds", "Startup recovery sweep wall time")

_GC_RUNS = obs_metrics.counter(
    "bkw_gc_runs_total", "GC runs by outcome", ("outcome",))
_GC_BYTES_RECLAIMED = obs_metrics.counter(
    "bkw_gc_bytes_reclaimed_total",
    "Bytes GC retired, by where they lived (remote placements vs local"
    " packfiles)", ("kind",))
_GC_PACKFILES_DROPPED = obs_metrics.counter(
    "bkw_gc_packfiles_dropped_total",
    "Packfiles GC retired with zero live bytes")
_GC_PACKFILES_COMPACTED = obs_metrics.counter(
    "bkw_gc_packfiles_compacted_total",
    "Sparse packfiles GC pulled back and re-packed")
_GC_SNAPSHOTS_PRUNED = obs_metrics.counter(
    "bkw_gc_snapshots_pruned_total",
    "Snapshots retention marked dead")

# Crash-matrix seams around the engine's multi-step placement commits
_CP_PLACE_PRE = faults.register_crash_site("placement.insert.pre")
_CP_PLACE_POST = faults.register_crash_site("placement.insert.post")
_CP_STRIPE_PRE = faults.register_crash_site("stripe.finish.pre")
_CP_STRIPE_POST = faults.register_crash_site("stripe.finish.post")
_CP_REHOME_PRE = faults.register_crash_site("repair.rehome.pre")
_CP_REHOME_POST = faults.register_crash_site("repair.rehome.post")
# GC's multi-step seams (docs/lifecycle.md): prune commit, sweep-plan
# manifest, compaction seal, make-before-break placement swap, reclaim
# retire — each bracketed pre/post like the placement seams above
_CP_GC_PRUNE_PRE = faults.register_crash_site("gc.prune.pre")
_CP_GC_PRUNE_POST = faults.register_crash_site("gc.prune.post")
_CP_GC_SWEEP_PRE = faults.register_crash_site("gc.sweep.pre")
_CP_GC_SWEEP_POST = faults.register_crash_site("gc.sweep.post")
_CP_GC_SEAL_PRE = faults.register_crash_site("gc.compact.seal.pre")
_CP_GC_SEAL_POST = faults.register_crash_site("gc.compact.seal.post")
_CP_GC_SWAP_PRE = faults.register_crash_site("gc.swap.pre")
_CP_GC_SWAP_POST = faults.register_crash_site("gc.swap.post")
_CP_GC_RECLAIM_PRE = faults.register_crash_site("gc.reclaim.pre")
_CP_GC_RECLAIM_POST = faults.register_crash_site("gc.reclaim.post")


def _registry_stage_sums() -> Dict[str, float]:
    """Cumulative per-stage seconds from the registry — the source the
    end-of-run summary frame is derived from (deltas against a baseline
    captured at run start, since the registry is process-global)."""
    reg = obs_metrics.registry()
    out: Dict[str, float] = {}
    pack = reg.get("bkw_pack_stage_seconds")
    if pack is not None:
        for stage in ("seal", "write", "stall", "chunk_hash"):
            out[stage] = pack.sum_value(stage=stage)
    for metric, label in (("bkw_transfer_send_seconds", "send"),
                          ("bkw_transfer_wait_seconds", "send_wait")):
        fam = reg.get(metric)
        if fam is not None:
            out[label] = fam.sum_value()
    return out


class Orchestrator:
    """Cross-task shared state (backup_orchestrator.rs:20-45)."""

    def __init__(self):
        self.bytes_written = 0
        self.bytes_sent = 0
        # incremental local-buffer accounting: seeded with leftovers from
        # a previous interrupted run, bumped by on_packfile, drained by
        # sends — so backpressure never re-stats the whole pack dir on
        # every loop tick (VERDICT r2 weak 5)
        self.buffer_bytes = 0
        # buffer_bytes is bumped from the packer executor thread and
        # drained on the event loop; the lock keeps the read-modify-write
        # from losing updates (directory rescans would eventually
        # reconcile, but backpressure would act on a stale counter)
        self._buffer_lock = threading.Lock()
        self.packing_completed = False
        self.failed = False
        self._resume = threading.Event()
        self._resume.set()
        # seal->send wakeup (docs/dataflow.md): the packfile writer
        # thread signals through call_soon_threadsafe(notify_packfile),
        # so the send loop wakes the moment a packfile commits instead
        # of polling on a backoff timer
        self._packfile_event = asyncio.Event()
        self.active_transports: Dict[bytes, Transport] = {}

    def notify_packfile(self) -> None:
        """Event-loop side of the seal wakeup: a packfile committed (or
        packing finished — the producer must fire this after flipping
        ``packing_completed`` so a parked send loop sees the flag)."""
        self._packfile_event.set()

    async def wait_packfile(self, timeout: float) -> None:
        """Park the send loop until the next seal commit.  ``timeout``
        is only a missed-wakeup backstop, not pacing: the caller's loop
        re-reads the buffer counter after every return either way."""
        if self._packfile_event.is_set():
            self._packfile_event.clear()
            return
        try:
            await asyncio.wait_for(self._packfile_event.wait(), timeout)
        except asyncio.TimeoutError:
            return
        self._packfile_event.clear()

    def adjust_buffer(self, delta: int) -> None:
        with self._buffer_lock:
            self.buffer_bytes += delta

    def set_buffer(self, value: int) -> None:
        with self._buffer_lock:
            self.buffer_bytes = value

    # pause/resume (backup_orchestrator.rs:81-113)
    def pause(self) -> None:
        self._resume.clear()

    def resume(self) -> None:
        self._resume.set()

    @property
    def paused(self) -> bool:
        return not self._resume.is_set()

    def block_if_paused(self) -> None:
        """Called from the packer thread between blobs
        (block_if_paused! macro, backup/mod.rs:241-250)."""
        self._resume.wait()


class Engine:
    def __init__(self, keys: KeyManager, store: Store, server: ServerClient,
                 node: P2PNode, backend: Optional[ChunkerBackend] = None,
                 messenger=None, dedup_device=None):
        self.keys = keys
        self.store = store
        self.server = server
        self.node = node
        self.backend = backend or select_backend()
        self.messenger = messenger
        self.index = BlobIndex(keys, self._index_dir())
        self.index.load()
        self.challenge_tables = ChallengeTable(keys, store.challenge_dir())
        # with a device attached, dedup decisions run batched on the
        # sharded device table; BlobIndex stays the persisted authority +
        # parity oracle.  On the GPU backend the front is attached by
        # DEFAULT (on the backend's device) so real runs exercise the
        # device table without caller plumbing (SURVEY §7 3e);
        # BKW_DEVICE_DEDUP=0 opts out.
        if dedup_device is None and getattr(self.backend, "name", "") == "gpu" \
                and os.environ.get("BKW_DEVICE_DEDUP", "1") != "0":
            dedup_device = self.backend.device
        self.device_dedup = None
        if dedup_device is not None:
            self.device_dedup = self._make_device_dedup(dedup_device)
            # the manifest pipeline shards batches over the same mesh so
            # digests can hand off to the dedup table on device (no port
            # backend has a mesh yet: ROADMAP §1 item 8)
            if hasattr(self.backend, "attach_mesh"):
                self.backend.attach_mesh(dedup_device,
                                         self.device_dedup.n_shards)
        self.orchestrator = Orchestrator()
        self.last_pack_stats = None
        # backup and restore are mutually exclusive and non-reentrant
        # (restore_orchestrator.rs:45-56); a second start must fail loudly,
        # not corrupt the pack dir with a concurrent packer
        self._exclusive = asyncio.Lock()
        # peer-loss repair: the demotion hook spawns repair rounds unless a
        # test drives them explicitly; _avoid_peers excludes the peers
        # under repair from placement while a round runs
        self.auto_repair = True
        self._repair_task: Optional[asyncio.Task] = None
        self._avoid_peers: set = set()
        # transfer plane of the most recent send loop (telemetry seam)
        self._transfers: Optional[TransferScheduler] = None
        # per-peer throughput/latency/success estimators, persisted in the
        # client config DB (net/peer_stats.py; the WAN-aware scheduling
        # measurement seam)
        self.peer_stats = PeerStats(store)
        # per-backup dispatch/bytes/padding roll-up (obs/profile.py)
        self.last_pipeline_report = None
        # per-backup overlap verdict (wall vs max stage, docs/dataflow.md)
        self.last_overlap = None
        # most recent startup recovery sweep report (engine.recover)
        self.last_recovery: Optional[Dict] = None

    # --- paths -------------------------------------------------------------

    def _make_device_dedup(self, device, n_shards: int = 1):
        """Device dedup front on ``device``: tiered by default.

        The tiered front keeps the device table under
        ``DEDUP_HBM_BUDGET_BYTES`` with the LSM cold tier under the
        store's data dir absorbing demoted fingerprints
        (docs/dedup_tiering.md); ``BKW_DEDUP_TIERED=0`` falls back to
        the grow-only :class:`MeshDedupIndex`.
        """
        if os.environ.get("BKW_DEDUP_TIERED", "1") != "0":
            return TieredDedupIndex(
                self.index, n_shards, device=device,
                cold_dir=self.store.dedup_cold_dir())
        from .snapshot.device_dedup import MeshDedupIndex
        return MeshDedupIndex(self.index, n_shards, device=device)

    def _pack_dir(self) -> Path:
        return self.store.packfile_dir()

    def _index_dir(self) -> Path:
        return self.store.index_dir()

    def _log(self, msg: str) -> None:
        if self.messenger is not None:
            self.messenger.log(msg)

    def _progress(self, **kw) -> None:
        if self.messenger is not None:
            self.messenger.progress(**kw)

    # --- size estimate (backup/mod.rs:207-238) -----------------------------

    def estimate_size(self, root: Path) -> int:
        last = self.store.last_backup_size()
        total = 0
        for dirpath, _dirnames, filenames in os.walk(root):
            for f in filenames:
                try:
                    total += (Path(dirpath) / f).stat().st_size
                except OSError:
                    pass
        if last is not None:
            # incremental estimate: only the size delta needs new storage
            return max(total - last, min(total, 50 * 1000 * 1000))
        return total

    # --- buffer accounting --------------------------------------------------

    def _unsent_packfiles(self) -> list:
        """(packfile_id, path, size) of every local packfile not yet sent."""
        out = []
        base = self._pack_dir()
        if not base.is_dir():
            return out
        for shard in sorted(base.iterdir()):
            if not shard.is_dir():
                continue
            for f in sorted(shard.iterdir()):
                if f.suffix:  # .tmp
                    continue
                try:
                    out.append((bytes.fromhex(f.name), f, f.stat().st_size))
                except (ValueError, OSError):
                    continue
        return out

    def _buffer_bytes(self) -> int:
        return sum(s for _, _, s in self._unsent_packfiles())

    @staticmethod
    async def _blocking(fn, *args):
        """Run blocking disk I/O on the executor: the send/stripe/repair
        paths must never stall the event loop on a read/unlink/scan."""
        return await asyncio.get_running_loop().run_in_executor(None, fn, *args)

    # --- startup recovery sweep (docs/crash_consistency.md) -----------------

    async def recover(self) -> Dict:
        """Reconcile disk against the config DB after a (possible) crash.

        Called by ``ClientApp.start`` before any scheduler runs, and
        idempotent: a second call on a consistent store reconciles zero
        items.  The sweep

        * deletes orphaned ``.tmp`` files a crashed tmp+replace commit
          left in the pack / index / challenge directories;
        * AEAD-verifies every leftover local packfile's header (the
          GCM tag is the recorded digest) — a torn file is dropped and
          its blobs forgotten so the next backup re-packs them;
        * re-adopts verified packfiles the blob index cannot name (the
          crash beat the index flush): their headers are authoritative,
          so the blobs roll forward into the index instead of being
          re-packed from source;
        * retires placement rows whose packfile neither the index nor
          the local disk can resurrect — unreachable peer bytes must not
          masquerade as durability;
        * finishes packfiles whose placements already completed (the
          crash hit between the last ack and the local unlink);
        * counts the rest as the drain backlog, and probes for
          under-placed stripes with the same
          :meth:`_queue_underplaced_stripes` walk the repair round uses;
        * clears stale ``repair_staging/`` and restore staging trees;
        * expires abandoned partial transfers past
          ``defaults.PARTIAL_STORE_TTL_S``.

        Emits a ``recovery_report`` journal event and ``bkw_recovery_*``
        metrics, then (when ``auto_repair`` is on and there is a backlog)
        schedules the normal background repair round to drain it.
        """
        if self._exclusive.locked():
            _BUSY_REJECTS.inc(op="recover")
            raise EngineError("a backup or restore is already running")
        async with self._exclusive:
            with obs_trace.span("engine.recover"):
                report = await self._blocking(self._recover_sync)
        if self.auto_repair and (report["packfiles_pending"]
                                 or report["stripes_underplaced"]):
            if self._repair_task is None or self._repair_task.done():
                self._repair_task = asyncio.create_task(self._auto_repair())
        return report

    def _recover_sync(self) -> Dict:
        t0 = time.monotonic()
        rep: Dict[str, int] = {
            "tmp_cleaned": 0,
            "packfiles_corrupt": 0,
            "packfiles_adopted": 0,
            "packfiles_completed": 0,
            "packfiles_pending": 0,
            "placements_retired": 0,
            "stripes_underplaced": 0,
            "staging_cleared": 0,
            "partials_expired": 0,
            "gc_rolled_back": 0,
            "gc_rolled_forward": 0,
        }

        # interrupted GC first: roll the swap forward or back BEFORE the
        # leftover-packfile walk below, so a rolled-back compacted
        # packfile is gone before adoption could mistake it for a normal
        # pending backup packfile (docs/lifecycle.md GC state machine)
        self._recover_gc_state(rep)

        # orphaned .tmp files from crashed tmp+replace commits
        pack_base = self._pack_dir()
        tmp_dirs = [self._index_dir(), self.store.challenge_dir()]
        if pack_base.is_dir():
            tmp_dirs.extend(d for d in pack_base.iterdir() if d.is_dir())
        for d in tmp_dirs:
            if not d.is_dir():
                continue
            for f in d.glob("*.tmp"):
                try:
                    f.unlink()
                    rep["tmp_cleaned"] += 1
                except OSError:
                    pass

        # leftover local packfiles: verify, adopt, finish, or keep for the
        # drain
        reader = PackfileReader(self.keys, pack_base)
        geom = self._stripe_geometry()
        for pid, path, _size in self._unsent_packfiles():
            try:
                entries = reader.read_header(pid)
            except Exception:
                # torn seal: drop the file and forget its blobs so the
                # next backup re-packs them from source (the repair
                # path's forget-then-repack contract)
                try:
                    path.unlink()
                except OSError:
                    pass
                self.index.forget_packfiles([pid])
                # its audit tables go with it: challenge state for a
                # dead packfile must not resurrect it as auditable
                self.challenge_tables.forget([pid])
                rep["packfiles_corrupt"] += 1
                continue
            if bytes(pid) not in self.index.packfile_ids():
                owned_elsewhere = entries and all(
                    self.index.lookup(e.hash) not in (None, bytes(pid))
                    for e in entries)
                if owned_elsewhere:
                    # a GC replacement whose plan was lost (crash before
                    # the seal was recorded in gc_state): every blob is
                    # still owned by the packfile it was compacted from,
                    # so adopting this copy would double-place the data
                    # and leave orphaned placements once it drained.
                    # Drop it; the next GC re-compacts from the owners.
                    try:
                        path.unlink()
                    except OSError:
                        pass
                    self.challenge_tables.forget([pid])
                    rep["gc_rolled_back"] += 1
                    continue
                # the crash beat the index flush: the sealed file is the
                # authoritative record (its header just AEAD-verified),
                # so roll FORWARD — re-adopt its blobs into the index
                # instead of re-packing them from source
                self.index.finalize_packfile(pid, [e.hash for e in entries])
                rep["packfiles_adopted"] += 1
            holders = set()
            whole_placed = False
            for _peer, idx in self.store.shards_for_packfile(pid):
                if idx < 0:
                    whole_placed = True
                else:
                    holders.add(int(idx))
            full_stripe = False
            if geom is not None and holders:
                expected = max(geom[0] + geom[1], max(holders) + 1)
                full_stripe = holders >= set(range(expected))
            if whole_placed or full_stripe:
                # every byte is acked on peers; only the local unlink
                # was lost to the crash
                try:
                    path.unlink()
                except OSError:
                    pass
                rep["packfiles_completed"] += 1
            else:
                rep["packfiles_pending"] += 1

        if rep["packfiles_adopted"]:
            self.index.flush()  # adoption must survive the next crash

        # placement rows for packfiles the index cannot name and no local
        # file can resurrect: unreachable forever (the mapping died with
        # the crashed process), so retire the rows — leaked peer bytes
        # stop masquerading as durability
        unsent_pids = {bytes(pid)
                       for pid, _p, _s in self._unsent_packfiles()}
        live_pids = self.index.packfile_ids()
        stale = sorted({(pid, peer) for pid, peer, _s, _i, _t
                        in self.store.all_placements()
                        if pid not in live_pids and pid not in unsent_pids})
        for pid, peer in stale:
            rep["placements_retired"] += \
                self.store.retire_placement(pid, peer)

        # under-placed stripes: the scar the repair round would revisit
        stripe_lost: Dict = {}
        self._queue_underplaced_stripes(stripe_lost, {}, set(), unsent_pids)
        rep["stripes_underplaced"] = len(stripe_lost)

        # stale staging trees: a crashed repair or restore re-pulls from
        # scratch, so half-staged bytes are only a disk leak
        for staging in (self.store.data_base / "repair_staging",
                        self.store.data_base / "gc_staging",
                        self.store.restore_dir()):
            if staging.is_dir() and any(staging.iterdir()):
                shutil.rmtree(staging, ignore_errors=True)
                rep["staging_cleared"] += 1

        # abandoned inbound partials (the receiver-side TTL janitor —
        # also run periodically on the durability sweep, app.py)
        rep["partials_expired"] = self.expire_partials()

        # "reconciled" counts state this sweep actually changed; pending
        # backlog is observed, not reconciled (the drain owns it)
        backlog = ("packfiles_pending", "stripes_underplaced")
        reconciled = sum(v for k, v in rep.items() if k not in backlog)
        for category, n in rep.items():
            if n and category not in backlog:
                _RECOVERY_ITEMS.inc(n, category=category)
        _RECOVERY_RUNS.inc()
        dt = time.monotonic() - t0
        _RECOVERY_SECONDS.observe(dt)
        rep["reconciled"] = reconciled
        rep["elapsed_s"] = round(dt, 6)
        obs_journal.emit("recovery_report", **rep)
        self.last_recovery = rep
        return rep

    def expire_partials(self) -> int:
        """Receiver-side TTL janitor over every peer's partial-transfer
        spill dir — shared by startup recovery and the periodic
        durability sweep (app.py), so abandoned partials age out even on
        long-lived processes that never restart."""
        expired = 0
        recv = self.store.data_base / "received_packfiles"
        if recv.is_dir():
            for peer_dir in recv.iterdir():
                part = peer_dir / "partial"
                if part.is_dir():
                    expired += PartialStore(part).expire()
        return expired

    def _recover_gc_state(self, rep: Dict) -> None:
        """Resolve a GC interrupted mid-flight (docs/lifecycle.md).

        The swap's durable index flush is the commit point.  After a
        crash the freshly-loaded index tells us which side we are on:
        an old packfile id still mapped means the flush never landed —
        roll BACK (the compacted replacements are re-derivable, the old
        placements are still authoritative); an old id gone (its hashes
        re-homed or tombstoned) means it did — roll FORWARD by re-running
        the idempotent swap body so retire/reclaim bookkeeping finishes.
        Runs before the leftover-packfile walk so a rolled-back
        replacement is deleted before adoption could mistake it for a
        pending backup packfile.
        """
        state = self.store.get_gc_state()
        if not state:
            return
        if state.get("phase") == "reclaim":
            # everything durable already committed; the reclaim_backlog
            # table carries the best-effort tail — the next GC drains it
            self.store.set_gc_state(None)
            rep["gc_rolled_forward"] += 1
            return
        new_map = {bytes.fromhex(h): [bytes.fromhex(x)
                                      for x in info["hashes"]]
                   for h, info in state.get("new", {}).items()}
        old_pids = [bytes.fromhex(h)
                    for h in list(state.get("drop", []))
                    + list(state.get("compact", []))]
        ids = self.index.packfile_ids()
        committed = (bool(set(new_map) & ids)
                     or any(pid not in ids for pid in old_pids))
        if committed and old_pids:
            self._gc_apply_swap(old_pids, new_map)
            # the interrupted run died before its accounting: attribute
            # the retired packfiles here (bytes are counted inside the
            # idempotent swap body itself)
            if state.get("drop"):
                _GC_PACKFILES_DROPPED.inc(len(state["drop"]))
            if state.get("compact"):
                _GC_PACKFILES_COMPACTED.inc(len(state["compact"]))
            self.store.set_gc_state(None)
            rep["gc_rolled_forward"] += 1
            return
        # pre-commit crash: the replacements never entered the index, so
        # delete their local files and audit tables, and hand any shards
        # already placed (make-before-break places FIRST) to the reclaim
        # backlog — the holders' bytes must not leak
        for npid in new_map:
            try:
                packfile_path(self._pack_dir(), npid).unlink()
            except OSError:
                pass
            self.challenge_tables.forget([npid])
            for peer, size, idx in self.store.placements_for_packfile(npid):
                fid = rs_stripe.shard_id(npid, idx) if idx >= 0 \
                    else bytes(npid)
                kind = wire.FileInfoKind.SHARD if idx >= 0 \
                    else wire.FileInfoKind.PACKFILE
                self.store.queue_reclaim(fid, peer, int(kind), size)
                self.store.retire_placement(npid, peer)
        self.store.set_gc_state(None)
        rep["gc_rolled_back"] += 1

    # --- snapshot lifecycle: retention, GC, compaction, reclaim -------------
    # (docs/lifecycle.md)

    async def run_gc(self, policy: Optional[str] = None) -> Dict:
        """Retention prune + mark-and-sweep GC + make-before-break
        compaction + remote reclaim, one serialized pass.

        Phases: *prune* (retention marks snapshots dead — lineage rows
        stay, data is untouched); *mark* (live set = blobs reachable
        from any retained snapshot's manifest); *sweep* (classify
        packfiles: zero live bytes drop, occupancy below
        ``GC_COMPACT_OCCUPANCY`` compacts; persist the plan); *compact*
        (pull sparse packfiles back k-of-n, re-pack only the live blobs,
        fresh challenge tables); *place* (new packfiles ride the normal
        RS send pipeline and must be acked BEFORE anything retires);
        *swap* (one durable index flush forgets old packfiles, finalizes
        replacements, tombstones dead blobs); *reclaim* (signed RECLAIM
        requests tell holders to drop superseded bytes, best-effort —
        the backlog table persists what did not drain).

        Holds the backup/restore exclusivity lock; at no instant may the
        invariant monitor see a retained snapshot's bytes unprotected.
        """
        if self._exclusive.locked():
            _BUSY_REJECTS.inc(op="gc")
            raise EngineError("a backup or restore is already running")
        async with self._exclusive:
            with obs_trace.span("engine.gc"):
                try:
                    report = await self._run_gc_locked(policy)
                except BaseException:
                    _GC_RUNS.inc(outcome="failed")
                    raise
        _GC_RUNS.inc(outcome="ok")
        return report

    async def _run_gc_locked(self, policy: Optional[str]) -> Dict:
        t0 = time.monotonic()
        report: Dict = {
            "snapshots_pruned": 0, "packfiles_dropped": 0,
            "packfiles_compacted": 0, "blobs_dropped": 0,
            "bytes_reclaimed_remote": 0, "bytes_reclaimed_local": 0,
            "placements_retired": 0, "reclaims_sent": 0,
            "reclaim_bytes_freed": 0, "refused": "",
        }

        # prune: one sqlite commit flips pruned_at on the victims
        faults.crashpoint(_CP_GC_PRUNE_PRE)
        pruned = await self._blocking(self.store.apply_retention, policy)
        faults.crashpoint(_CP_GC_PRUNE_POST)
        report["snapshots_pruned"] = len(pruned)
        if pruned:
            _GC_SNAPSHOTS_PRUNED.inc(len(pruned))
            self._log(f"gc: retention pruned {len(pruned)} snapshot(s)")

        # refuse to collect what we cannot reason about: no retained
        # snapshot at all, or retained snapshots predating the manifest
        # plane (their reachable set is unknowable — dropping anything
        # could tear them)
        retained = await self._blocking(self.store.retained_snapshots)
        unmanifested = await self._blocking(
            self.store.snapshots_without_manifest)
        if not retained or unmanifested:
            report["refused"] = (
                "no retained snapshots recorded"
                if not retained else
                f"{len(unmanifested)} retained snapshot(s) have no"
                " manifest (pre-lifecycle backups)")
            self._log(f"gc: refused: {report['refused']}")
            # a previous run's committed reclaims still deserve a drain
            report.update(await self._drain_reclaims())
            return self._gc_finish(report, t0)

        # mark + sweep classification (pure compute over two DB scans)
        live = await self._blocking(self.store.live_blobs)
        known = await self._blocking(self.store.manifest_blobs)
        drop, compact = self._gc_classify(live, known)

        # sweep-plan manifest: the roll-forward/roll-back record
        faults.crashpoint(_CP_GC_SWEEP_PRE)
        await self._blocking(self.store.set_gc_state, {
            "phase": "sweep",
            "drop": [p.hex() for p in drop],
            "compact": [p.hex() for p in compact],
            "new": {}})
        faults.crashpoint(_CP_GC_SWEEP_POST)

        # compact: pull the sparse packfiles' bytes back and re-pack
        # only the live blobs into fresh packfiles (fresh ids, fresh
        # challenge tables).  A packfile whose bytes cannot be staged is
        # left exactly as it was — never break what we could not rebuild.
        new_map: Dict[bytes, dict] = {}
        staging = self.store.data_base / "gc_staging"
        try:
            if compact:
                staged = await self._gc_stage_packfiles(compact, staging)
                short = [p for p in compact if p not in staged]
                if short:
                    self._log(f"gc: {len(short)} packfile(s) not stageable"
                              " this run; left in place")
                    compact = [p for p in compact if p in staged]
                if compact:
                    new_map = await self._blocking(
                        self._gc_repack, compact, staged, live)
            # compaction seal commit: the plan now names the replacements
            faults.crashpoint(_CP_GC_SEAL_PRE)
            await self._blocking(self.store.set_gc_state, {
                "phase": "place",
                "drop": [p.hex() for p in drop],
                "compact": [p.hex() for p in compact],
                "new": {pid.hex(): {"hashes": [h.hex() for h in info["hashes"]],
                                    "size": info["size"]}
                        for pid, info in new_map.items()}})
            faults.crashpoint(_CP_GC_SEAL_POST)
        finally:
            await self._blocking(
                lambda: shutil.rmtree(staging, ignore_errors=True))

        # place (make BEFORE break): the replacements travel the normal
        # RS send pipeline — striped, per-shard challenge tables, local
        # copies unlinked only on the holders' signed acks
        if new_map:
            orch = self.orchestrator = Orchestrator()
            orch.set_buffer(self._buffer_bytes())
            orch.packing_completed = True
            estimate = max(sum(i["size"] for i in new_map.values()), 1)
            await self._send_loop(orch, estimate)

        # swap: ONE durable commit breaks the old placements' authority
        faults.crashpoint(_CP_GC_SWAP_PRE)
        swap = await self._blocking(
            self._gc_apply_swap, drop + compact,
            {pid: info["hashes"] for pid, info in new_map.items()})
        # accounting rides the commit: the swap body counted the bytes,
        # the packfile counts land here, both BEFORE the post-swap seam
        # so a crash there does not lose the run's evidence
        if drop:
            _GC_PACKFILES_DROPPED.inc(len(drop))
        if compact:
            _GC_PACKFILES_COMPACTED.inc(len(compact))
        await self._blocking(self.store.set_gc_state, {"phase": "reclaim"})
        faults.crashpoint(_CP_GC_SWAP_POST)
        report["packfiles_dropped"] = len(drop)
        report["packfiles_compacted"] = len(compact)
        report["blobs_dropped"] = swap["blobs_dropped"]
        report["placements_retired"] = swap["placements_retired"]
        report["bytes_reclaimed_remote"] = swap["remote_bytes"]
        report["bytes_reclaimed_local"] = swap["local_bytes"]
        # manifest rows of pruned snapshots are only needed as the
        # occupancy denominator until their blobs are collected
        await self._blocking(self.store.drop_pruned_manifests)

        # the swap's flush minted new index file(s); ship them before the
        # old bytes retire, so a restore rebuilt purely from peers sees
        # the post-GC map (tombstones included) rather than a stale map
        # naming packfiles the holders are about to delete
        await self._gc_ship_index()

        # reclaim retire: best-effort; whatever does not drain stays in
        # the backlog table for the next run (or recovery)
        faults.crashpoint(_CP_GC_RECLAIM_PRE)
        report.update(await self._drain_reclaims())
        await self._blocking(self.store.set_gc_state, None)
        faults.crashpoint(_CP_GC_RECLAIM_POST)
        return self._gc_finish(report, t0)

    async def _gc_ship_index(self) -> None:
        """Send index files past the watermark to a holder (the same
        sequential protocol as a backup's tail).  Best-effort: with no
        storage peers on record (offline runs, drop-only unit tests) the
        next backup's send loop resumes from the watermark instead."""
        if self.node is None or not self.store.find_peers_with_storage():
            return
        orch = self.orchestrator
        orch.packing_completed = True
        await self._send_index_files(orch, 1, 0)

    def _gc_finish(self, report: Dict, t0: float) -> Dict:
        report["elapsed_s"] = round(time.monotonic() - t0, 6)
        self.store.add_event(EVENT_GC, {
            k: report[k] for k in (
                "snapshots_pruned", "packfiles_dropped",
                "packfiles_compacted", "blobs_dropped",
                "bytes_reclaimed_remote", "bytes_reclaimed_local",
                "refused")})
        obs_journal.emit("gc_report", **report)
        self._log(
            f"gc done: {report['packfiles_dropped']} dropped,"
            f" {report['packfiles_compacted']} compacted,"
            f" {report['bytes_reclaimed_remote']} remote byte(s) retired")
        return report

    def _gc_classify(self, live: Dict[bytes, int],
                     known: Dict[bytes, int]) -> tuple:
        """Split the index's packfiles into (drop, compact) lists.

        Occupancy is judged on manifest-known payload bytes only: a blob
        no manifest (retained OR pruned) names is invisible to GC — it
        is never counted and never collected (the refuse-guard upstream
        keeps pre-lifecycle retained data out of here entirely).
        """
        totals: Dict[bytes, int] = {}
        alive: Dict[bytes, int] = {}
        for h, pid in self.index.blob_map().items():
            size = known.get(h)
            if size is None:
                continue
            totals[pid] = totals.get(pid, 0) + size
            if h in live:
                alive[pid] = alive.get(pid, 0) + size
        drop, compact = [], []
        for pid, total in sorted(totals.items()):
            live_bytes = alive.get(pid, 0)
            if live_bytes == 0:
                drop.append(pid)
            elif total and live_bytes / total < defaults.GC_COMPACT_OCCUPANCY:
                compact.append(pid)
        return drop, compact

    async def _gc_stage_packfiles(self, pids: list,
                                  staging: Path) -> Dict[bytes, Path]:
        """Obtain readable plaintext-decryptable bytes for each packfile
        to compact: a copy still sitting in the local pack dir is used
        directly (no pull); otherwise the k survivor shards come back
        over the restore data plane (hedged, fastest-first) with a
        whole-copy fetch as fallback, and stripes assemble in a private
        staging tree.  Returns {packfile_id: base_dir for PackfileReader}.
        """
        staged: Dict[bytes, Path] = {}
        need_pull = []
        for pid in pids:
            pid = bytes(pid)
            if packfile_path(self._pack_dir(), pid).is_file():
                staged[pid] = self._pack_dir()
            else:
                need_pull.append(pid)
        if not need_pull:
            return staged
        await self._blocking(
            lambda: shutil.rmtree(staging, ignore_errors=True))
        staging.mkdir(parents=True, exist_ok=True)
        writer = RestoreFilesWriter(self.store, base=staging)
        sched = TransferScheduler(messenger=self.messenger,
                                  peer_stats=self.peer_stats)
        geom = self._stripe_geometry()
        for pid in need_pull:
            shard_map: Dict[int, tuple] = {}
            whole = []
            for peer, size, idx in self.store.placements_for_packfile(pid):
                if idx < 0:
                    whole.append((peer, size))
                else:
                    shard_map[idx] = (peer, size)
            got = 0
            k = geom[0] if geom is not None else defaults.RS_K
            if shard_map:
                got = await self._pull_stripe(pid, shard_map, writer, sched)
            if got < min(k, len(shard_map)) or (not shard_map and whole):
                for peer, size in whole:
                    wants = [(wire.FileInfoKind.PACKFILE, pid)]
                    res = await sched.submit_pull(
                        peer, size,
                        self._fetch_job(peer, wants, writer, size),
                        label=f"gc:whole:{pid.hex()[:8]}")
                    if res.ok:
                        break
        shard_root = staging / "shard"
        if shard_root.is_dir():
            await self._blocking(lambda: rs_stripe.assemble_tree(
                shard_root, staging / "pack", self.backend))
        for pid in need_pull:
            if packfile_path(staging / "pack", pid).is_file():
                staged[pid] = staging / "pack"
        return staged

    def _gc_repack(self, compact: list, staged: Dict[bytes, Path],
                   live: Dict[bytes, int]) -> Dict[bytes, dict]:
        """Re-pack the live blobs of the sparse packfiles into fresh
        packfiles (executor thread).  The replacements get challenge
        tables built from their local ciphertext at seal time — the same
        audit seam a backup seal uses — but are NOT finalized into the
        blob index yet: that happens atomically in the swap, after the
        new placements are acked.  Returns
        {new_packfile_id: {"hashes": [...], "size": int}}.
        """
        new_map: Dict[bytes, dict] = {}

        def on_sealed(pid, path, hashes, size):
            try:
                if not self.challenge_tables.has(pid):
                    self.challenge_tables.save(
                        pid, build_challenge_table(
                            self.backend, path.read_bytes(),
                            count=defaults.AUDIT_CHALLENGES_PER_PACKFILE))
            except Exception as e:
                self._log(f"gc: challenge table for "
                          f"{bytes(pid).hex()[:8]} failed: {e}")
            new_map[bytes(pid)] = {
                "hashes": [bytes(h) for h in hashes], "size": int(size)}

        owner = self.index.blob_map()
        writer = PackfileWriter(self.keys, self._pack_dir(),
                                on_packfile=on_sealed)
        try:
            for old_pid in compact:
                old_pid = bytes(old_pid)
                reader = PackfileReader(self.keys, staged[old_pid])
                for blob in reader.iter_blobs(old_pid):
                    h = bytes(blob.hash)
                    # keep a blob only if it is live AND this packfile is
                    # its one committed home — a hash owned elsewhere
                    # would otherwise be duplicated
                    if h in live and owner.get(h) == old_pid:
                        writer.add_blob(blob)
            writer.flush()
        finally:
            writer.shutdown()
        return new_map

    def _gc_apply_swap(self, old_pids: list,
                       new_map: Dict[bytes, list]) -> Dict[str, int]:
        """The break half of make-before-break, idempotent (the recovery
        roll-forward re-runs it verbatim): forget the old packfiles,
        finalize the replacements, tombstone the blobs nothing names any
        more, and flush — ONE durable index commit.  Only then do the
        old audit tables, local copies, and placement rows retire, each
        superseded remote file going onto the reclaim backlog.
        """
        lost = self.index.forget_packfiles(old_pids)
        for npid, hashes in new_map.items():
            self.index.finalize_packfile(npid, hashes)
        dead = sorted(h for h in lost if self.index.lookup(h) is None)
        self.index.record_tombstones(dead)
        self.index.flush()  # <- the commit point
        self.challenge_tables.forget(old_pids)
        local_bytes = 0
        remote_bytes = 0
        retired = 0
        for pid in old_pids:
            pid = bytes(pid)
            path = packfile_path(self._pack_dir(), pid)
            try:
                local_bytes += path.stat().st_size
                path.unlink()
            except OSError:
                pass
            for peer, size, idx in self.store.placements_for_packfile(pid):
                fid = rs_stripe.shard_id(pid, idx) if idx >= 0 else pid
                kind = wire.FileInfoKind.SHARD if idx >= 0 \
                    else wire.FileInfoKind.PACKFILE
                # queue-then-retire: a crash between the two re-queues on
                # the next pass (INSERT OR IGNORE), never leaks the row
                self.store.queue_reclaim(fid, peer, int(kind), size)
                retired += self.store.retire_placement(pid, peer)
                remote_bytes += size
        # counted here, not in the caller, so a recovery roll-forward's
        # re-run attributes whatever it finishes retiring; a re-run over
        # already-retired state finds zero bytes, so no double count
        if remote_bytes:
            _GC_BYTES_RECLAIMED.inc(remote_bytes, kind="remote")
        if local_bytes:
            _GC_BYTES_RECLAIMED.inc(local_bytes, kind="local")
        return {"blobs_dropped": len(dead),
                "placements_retired": retired,
                "remote_bytes": remote_bytes,
                "local_bytes": local_bytes}

    async def _drain_reclaims(self) -> Dict[str, int]:
        """Drain the reclaim backlog: one signed RECLAIM request per
        holder (batched to ``RECLAIM_MAX_ITEMS``), crediting our local
        view of the peer's quota and clearing rows only on its ack.
        Failures are isolated per peer; unreachable holders keep their
        rows for the next drain."""
        backlog = await self._blocking(self.store.reclaim_backlog)
        sent = 0
        freed = 0
        by_peer: Dict[bytes, list] = {}
        for fid, peer, kind, size in backlog:
            by_peer.setdefault(peer, []).append((fid, kind, size))
        for peer, items in sorted(by_peer.items()):
            if self.node is None:
                break
            for start in range(0, len(items), defaults.RECLAIM_MAX_ITEMS):
                batch = items[start:start + defaults.RECLAIM_MAX_ITEMS]
                try:
                    t = await self.node.connect(
                        peer, wire.RequestType.RECLAIM,
                        timeout=self._dial_budget(peer))
                except (P2PError, ServerError, OSError,
                        asyncio.TimeoutError) as e:
                    self._log(f"gc: reclaim dial {peer.hex()[:8]}"
                              f" failed: {e}")
                    break
                try:
                    freed_now = await self.node.request_reclaim(
                        t, [(wire.FileInfoKind(kind), fid)
                            for fid, kind, _s in batch])
                except (P2PError, OSError, asyncio.TimeoutError) as e:
                    self._log(f"gc: reclaim to {peer.hex()[:8]}"
                              f" failed: {e}")
                    break
                finally:
                    await t.close()
                total = sum(s for _f, _k, s in batch)
                await self._blocking(
                    self.store.credit_peer_transmitted, peer, total)
                for fid, _kind, _s in batch:
                    await self._blocking(
                        self.store.clear_reclaim, fid, peer)
                sent += len(batch)
                freed += freed_now
        return {"reclaims_sent": sent, "reclaim_bytes_freed": freed}

    # --- backup ------------------------------------------------------------

    async def run_backup(self, root: Optional[Path] = None) -> bytes:
        if self._exclusive.locked():
            _BUSY_REJECTS.inc(op="backup")
            raise EngineError("a backup or restore is already running")
        async with self._exclusive:
            with obs_trace.span("engine.backup"):
                try:
                    snapshot = await self._run_backup_locked(root)
                except BaseException:
                    _BACKUP_RUNS.inc(outcome="failed")
                    raise
            _BACKUP_RUNS.inc(outcome="ok")
            return snapshot

    async def _run_backup_locked(self, root: Optional[Path]) -> bytes:
        root = Path(root or (self.store.get_backup_path() or ""))
        if not root.is_dir():
            raise EngineError(f"backup path {root} is not a directory")
        stage_base = _registry_stage_sums()
        profile_base = obs_profile.baseline()
        orch = self.orchestrator = Orchestrator()
        loop = asyncio.get_running_loop()
        # the size estimate walks the whole tree: keep it off the event
        # loop (backup/mod.rs:207-238 runs it blocking; we cannot)
        estimate = await loop.run_in_executor(None, self.estimate_size, root)
        orch.set_buffer(self._buffer_bytes())  # leftovers from past runs
        self._log(f"backup started, estimated {estimate} bytes")
        self._progress(size_estimate=estimate, running=True)
        snapshot_holder: dict = {}
        # the snapshot's reachable-blob manifest, collected as the packer
        # visits every blob (duplicates included) — GC's mark phase is a
        # join against this, persisted atomically with the lineage row.
        # Written only from the single pack thread, read after it joins.
        manifest: Dict[bytes, int] = {}
        # contextvars do not cross run_in_executor: hand the backup's
        # trace id to the pack thread so its spans journal under it
        backup_tid = obs_trace.current_trace_id()

        def pack_thread() -> None:
            writer = PackfileWriter(
                self.keys, self._pack_dir(),
                on_packfile=self._on_packfile_threadsafe(loop),
                seal_workers=defaults.PACK_SEAL_WORKERS)
            packer = DirPacker(self.backend, writer, self.index,
                               progress=self._pack_progress,
                               should_pause=orch.block_if_paused,
                               dedup_index=self.device_dedup,
                               on_blob=lambda h, s: manifest.setdefault(h, s))
            try:
                with obs_trace.bind(backup_tid), \
                        tracing.span("engine.pack"), \
                        tracing.device_profiler("backup_pack"):
                    snapshot_holder["hash"] = packer.pack(root)
                snapshot_holder["stats"] = packer.stats
            finally:
                writer.shutdown()

        # BKW_BACKUP_PHASED=1 is the sum(stage) baseline leg the bench
        # speedup ratio is measured against: the send stage starts only
        # after the full pack finished, so nothing overlaps the wire.
        # Default is the streaming dataflow — pack, seal, and send all
        # concurrently busy, linked by bounded queues (docs/dataflow.md).
        phased = os.environ.get("BKW_BACKUP_PHASED", "0") == "1"
        wall_t0 = time.monotonic()
        pack_fut = loop.run_in_executor(None, pack_thread)
        send_task = None
        if not phased:
            send_task = asyncio.create_task(self._send_loop(orch, estimate))
        try:
            await pack_fut
            orch.packing_completed = True
            # wake a send loop parked on the seal event: no more seal
            # commits are coming, the drain check must run now
            orch.notify_packfile()
            await self._blocking(self.index.flush)
        except BaseException:
            # BaseException on purpose: an injected CrashInjected (and a
            # cancel of this coroutine) must still tear down the send
            # loop instead of leaving it spinning against a dead backup
            orch.failed = True
            if send_task is not None:
                send_task.cancel()
            raise
        if send_task is None:
            send_task = asyncio.create_task(self._send_loop(orch, estimate))
        try:
            await send_task
        except asyncio.CancelledError:
            raise EngineError("send pipeline cancelled")
        wall_s = time.monotonic() - wall_t0
        snapshot = snapshot_holder["hash"]
        self.last_pack_stats = snapshot_holder["stats"]
        # per-stage roll-up, derived from the metrics registry (delta vs.
        # the baseline captured at run start) — one source of truth
        # shared with GET /metrics and the messenger summary below
        now_sums = _registry_stage_sums()
        stages = {k: now_sums.get(k, 0.0) - stage_base.get(k, 0.0)
                  for k in now_sums}
        # overlap verdict for the dataflow gate: busy stages only (stall
        # and send_wait are idle time by definition — counting them
        # would reward a stalled pipeline)
        self.last_overlap = obs_profile.overlap_report(
            {k: stages.get(k, 0.0)
             for k in ("chunk_hash", "seal", "write", "send")},
            wall_s, mode="phased" if phased else "stream")
        # lineage + manifest commit (one store transaction): parent is
        # the previous retained head, so prune/GC can reason about the
        # chain (docs/lifecycle.md)
        parent = self.store.latest_snapshot()
        await self._blocking(
            self.store.record_snapshot, snapshot,
            None if parent is None else parent.hash,
            snapshot_holder["stats"].bytes_read, list(manifest.items()))
        await self.server.backup_done(snapshot)
        self.store.add_event(EVENT_BACKUP, {
            "size": snapshot_holder["stats"].bytes_read,
            "snapshot": snapshot.hex()})
        # per-backup pipeline report: dispatch counts, bytes, padding
        # efficiency, stage seconds — the number the round-5 digest-merge
        # gate watches (PERF.md)
        self.last_pipeline_report = obs_profile.report(profile_base)
        obs_profile.emit_report(
            self.last_pipeline_report, snapshot=snapshot.hex(),
            backend=getattr(self.backend, "name", "?"),
            bytes_read=snapshot_holder["stats"].bytes_read)
        self._log(f"backup finished: {snapshot.hex()}")
        if self.messenger is not None:
            self.messenger.transfer("engine", "summary",
                                    size=orch.bytes_sent, stages=stages,
                                    overlap=self.last_overlap)
        if tracing.enabled():
            self._log("trace spans:\n" + tracing.format_report())
        return snapshot

    def _pack_progress(self, **kw) -> None:
        self._progress(**kw)

    def _on_packfile_threadsafe(self, loop):
        def cb(pid, path, hashes, size):
            self.index.finalize_packfile(pid, hashes)
            # Precompute the audit challenge table while the plaintext
            # packfile is still local (it is unlinked after the peer's
            # ack) — hashed in one device batch alongside packing.  A
            # failure here degrades auditing, never the backup itself.
            try:
                if not self.challenge_tables.has(pid):
                    self.challenge_tables.save(
                        pid, build_challenge_table(
                            self.backend, path.read_bytes(),
                            count=defaults.AUDIT_CHALLENGES_PER_PACKFILE))
            except Exception as e:
                self._log(f"challenge table for {bytes(pid).hex()[:8]}"
                          f" failed: {e}")
            self.orchestrator.bytes_written += size
            self.orchestrator.adjust_buffer(size)
            self._progress(bytes_on_disk=self.orchestrator.bytes_written)
            # continuous admission: wake the send loop NOW — the buffer
            # counter above is already visible, so the packfile can be
            # on the wire before the next seal finishes
            loop.call_soon_threadsafe(self.orchestrator.notify_packfile)
        return cb

    # --- send pipeline (send.rs) -------------------------------------------

    async def _send_loop(self, orch: Orchestrator, estimate: int) -> None:
        fulfilled = 0
        # the concurrent transfer plane: bounded in-flight bytes, per-peer
        # ordering, per-transfer failure isolation (net/transfer.py).  One
        # scheduler per send loop so serial/concurrent knobs re-read
        # defaults each run.
        sched = self._transfers = TransferScheduler(
            messenger=self.messenger, peer_stats=self.peer_stats)
        # unified retry shapes (utils/retry.py): the storage re-request
        # backs off across consecutive dry spells, the peer wait grows
        # toward its cap while idle and resets on progress.  Waiting on
        # the PACKER is not a retry anymore: the seal callback's event
        # wakes this loop directly (Orchestrator.wait_packfile).
        request_timer = retry.RetryTimer(retry.STORAGE_REQUEST)
        peer_wait = retry.Backoff(retry.PEER_WAIT)
        # continuous admission (docs/dataflow.md): every packfile handed
        # to the transfer plane is tracked here (pid -> its admission
        # tick's task) until its tick resolves.  The scan below skips
        # tracked pids — a slow transfer never blocks admission of the
        # next sealed packfile, and a file still on disk (it is unlinked
        # only post-ack) is never double-submitted.
        inflight: Dict[bytes, "asyncio.Task[int]"] = {}

        async def reap(wait: bool) -> None:
            """Fold finished admission ticks into the loop's accounting;
            with ``wait`` parks until at least one tick resolves.  An
            injected crash inside a tick re-raises here."""
            nonlocal fulfilled
            if not inflight:
                return
            done, _pending = await asyncio.wait(
                set(inflight.values()), timeout=None if wait else 0,
                return_when=asyncio.FIRST_COMPLETED)
            if not done:
                return
            for pid in [p for p, t in inflight.items() if t in done]:
                del inflight[pid]
            for t in done:
                placed = t.result()
                if placed:
                    fulfilled += placed
                    peer_wait.reset()
                    self._progress(bytes_transmitted=orch.bytes_sent)

        async def reap_or_seal() -> None:
            """Park until an in-flight tick resolves OR the next seal
            commit — whichever lets the loop make progress first."""
            waiter = asyncio.ensure_future(
                orch.wait_packfile(defaults.SEND_WAKEUP_BACKSTOP_S))
            try:
                await asyncio.wait({waiter, *inflight.values()},
                                   return_when=asyncio.FIRST_COMPLETED)
            finally:
                if not waiter.done():
                    waiter.cancel()
                    try:
                        await waiter
                    except asyncio.CancelledError:
                        pass
            await reap(wait=False)

        try:
            while True:
                buffer = orch.buffer_bytes
                # backpressure (send.rs:52-54, 95-100)
                if buffer > defaults.PACKFILE_LOCAL_BUFFER_LIMIT \
                        and not orch.paused:
                    orch.pause()
                    self._log("packing paused: local buffer full")
                elif orch.paused and (
                        defaults.PACKFILE_LOCAL_BUFFER_LIMIT - buffer
                        > defaults.PACKFILE_RESUME_THRESHOLD):
                    orch.resume()
                    self._log("packing resumed")
                await reap(wait=False)
                if buffer <= 0:
                    if not orch.packing_completed:
                        # event-driven: the seal callback wakes this loop
                        # the moment a packfile commits (no dir scan, no
                        # backoff poll); the timeout is only a
                        # missed-wakeup backstop
                        await orch.wait_packfile(
                            defaults.SEND_WAKEUP_BACKSTOP_S)
                        continue
                    if inflight:
                        await reap(wait=True)
                        continue
                    # counter says drained: confirm with one real scan
                    # before finishing (the counter is advisory, the dir
                    # is truth)
                    unsent = await self._blocking(self._unsent_packfiles)
                    if not unsent:
                        break
                    orch.set_buffer(sum(s for _, _, s in unsent))
                else:
                    unsent = await self._blocking(self._unsent_packfiles)
                    unsent = [u for u in unsent
                              if bytes(u[0]) not in inflight]
                    if not unsent:
                        if inflight:
                            # everything on disk is already admitted:
                            # wait for a completion or the next seal
                            await reap_or_seal()
                        elif not orch.packing_completed:
                            await orch.wait_packfile(
                                defaults.SEND_WAKEUP_BACKSTOP_S)
                        else:
                            orch.set_buffer(0)
                        continue
                # admit the fresh batch WITHOUT awaiting it: the tick
                # task owns these pids until its transfers resolve, and
                # the loop goes straight back to watching the seal queue
                tick = asyncio.create_task(self._send_tick(
                    orch, sched, unsent, estimate, fulfilled,
                    request_timer, peer_wait))
                for pid, _path, _size in unsent:
                    inflight[bytes(pid)] = tick
        except BaseException:
            # teardown (cancel or injected crash): the admission ticks
            # must not outlive the loop and spin against a dead backup
            for t in set(inflight.values()):
                t.cancel()
            if inflight:
                await asyncio.gather(*set(inflight.values()),
                                     return_exceptions=True)
            raise
        # index files last, watermarked (send.rs:135-176)
        await self._send_index_files(orch, estimate, fulfilled)

    async def _send_tick(self, orch: Orchestrator, sched: TransferScheduler,
                         unsent: list, estimate: int, fulfilled: int,
                         request_timer, peer_wait) -> int:
        """One admission batch: stripe what can reach k+m distinct peers,
        fan the rest out whole-file.  Returns bytes fully placed; files
        that could not go out stay on disk and leave the in-flight set
        when this task resolves, so the next scan retries them.  The
        peer-wait backoff on a dry tick happens HERE (while the pids are
        still tracked), so a peerless swarm cannot spin the scan loop."""
        placed = 0
        # erasure-first: any packfile that can reach RS_K+RS_M distinct
        # peers right now goes out as a shard stripe; the rest fall
        # through to the whole-file path below, so small swarms behave
        # exactly as before sharding existed
        unsent, striped = await self._send_stripes(orch, sched, unsent)
        if striped:
            placed += striped
            request_timer.reset()
            self._progress(bytes_transmitted=orch.bytes_sent)
        if not unsent:
            return placed
        # a peer only qualifies if it can take the next packfile —
        # otherwise an almost-full peer would be reacquired forever
        # and the storage-request branch would starve
        transport, peer_id, peer_free = await self._get_peer_connection(
            orch, estimate, fulfilled, request_timer,
            min_free=min(s for _, _, s in unsent))
        if transport is None:
            await peer_wait.sleep()
            return placed
        peer_wait.reset()
        request_timer.reset()
        sent = await self._send_whole_files(
            orch, sched, unsent, (transport, bytes(peer_id), peer_free))
        if sent:
            placed += sent
        else:
            if not sched.peer_busy(peer_id):
                # dry tick on an idle socket: recycle it so the next scan
                # re-evaluates peers fresh.  A busy socket stays — sibling
                # ticks still have acks pending on it.
                await self._drop_transport(orch, peer_id)
            await peer_wait.sleep()
        return placed

    async def _send_whole_files(self, orch: Orchestrator,
                                sched: TransferScheduler, unsent: list,
                                first_conn) -> int:
        """Whole-packfile fan-out: distribute ``unsent`` over up to
        TRANSFER_MAX_PEERS connected peers and put every assigned file in
        flight concurrently (per-peer ordering preserved by the plane).
        Returns bytes acked; failed peers are dropped, their files stay
        on disk for the next tick.
        """
        # allowance-tracked connections, the qualifying peer first
        conns = [[first_conn[0], bytes(first_conn[1]), first_conn[2]]]
        if len(unsent) > 1 and defaults.TRANSFER_MAX_PEERS > 1:
            extra = await self._get_stripe_connections(
                orch, min(defaults.TRANSFER_MAX_PEERS, len(unsent)) - 1,
                {conns[0][1]} | self._avoid_peers,
                min(s for _, _, s in unsent))
            conns += [[t, bytes(p), free] for t, p, free in extra
                      if bytes(p) != conns[0][1]]
        tasks = []
        for pid, path, size in unsent:
            # Most-free connection that can take it; skip, don't stop:
            # unsent is in directory order, so a large packfile sorting
            # first must not starve smaller ones that still fit some peer
            # (the first peer qualified on min_free, the smallest file).
            best = None
            for c in conns:
                if size <= c[2] + defaults.PEER_OVERUSE_GRACE // 2 and (
                        best is None or c[2] > best[2]):
                    best = c
            if best is None:
                continue
            best[2] -= size
            tasks.append(sched.submit(
                best[1], size,
                self._whole_file_job(orch, best[0], best[1], pid, path, size),
                label=f"pack:{bytes(pid).hex()[:8]}"))
        sent = 0
        dropped = set()
        # completion-order reap: a failed peer is dropped (its transport
        # closed, its queued siblings failing fast) while the healthy
        # peers' transfers are still in flight
        async for r in sched.as_completed(tasks):
            if r.ok:
                sent += r.size
            elif isinstance(r.error, P2PError) and r.peer_id not in dropped:
                dropped.add(r.peer_id)
                await self._drop_transport(orch, r.peer_id)
        return sent

    def _peer_throughput(self, peer_id: bytes) -> float:
        """Measured EWMA throughput hint for adaptive deadlines; 0.0
        until the peer has enough samples to trust."""
        est = self.peer_stats.get(peer_id) if self.peer_stats else None
        if est is None or est.samples < defaults.PLACEMENT_MIN_SAMPLES:
            return 0.0
        return est.throughput_bps

    def _pull_rate(self, peer_id: bytes) -> float:
        """Source-selection score for download lanes: EWMA throughput
        derated by success ratio, with the neutral placement prior for
        never-measured peers so fresh holders stay schedulable between
        measured-fast and measured-slow ones."""
        est = self.peer_stats.get(peer_id) if self.peer_stats else None
        if est is None or est.samples < defaults.PLACEMENT_MIN_SAMPLES:
            return float(defaults.PLACEMENT_NEUTRAL_SCORE_BPS)
        return max(est.throughput_bps * max(est.success, 0.0), 1.0)

    def _dial_budget(self, peer_id: bytes) -> float:
        """Adaptive dial budget (the adaptive deadline policy applied to the
        rendezvous confirm): the base ack window plus the peer's measured
        EWMA latency derated by the transfer safety fraction, under the
        transfer deadline cap.  Replaces the old fixed 10 s guess so a
        slow-but-alive peer is not misclassified as dark while a truly
        dark one still fails within seconds."""
        est = self.peer_stats.get(peer_id) if self.peer_stats else None
        lat = 0.0
        if est is not None and est.samples > 0:
            lat = float(est.latency_s) / max(
                defaults.TRANSFER_DEADLINE_SAFETY, 1e-6)
        return min(defaults.TRANSFER_DEADLINE_CAP_S,
                   defaults.ACK_TIMEOUT_S + lat)

    async def _send_resumable(self, orch: Orchestrator, transport,
                              peer_id: bytes, data: bytes,
                              file_info: wire.FileInfoKind,
                              file_id: bytes) -> None:
        """The shared abort-and-resume loop
        (``TransferScheduler.run_resumable``) with this engine's
        connection bookkeeping plugged in: a failed attempt drops the
        poisoned transport from the orchestrator and a retry redials,
        registering the fresh transport so sibling jobs reuse it."""
        peer_id = bytes(peer_id)

        async def on_drop() -> None:
            await self._drop_transport(orch, peer_id)

        async def redial():
            if self.node is None:
                raise P2PError("reconnect for resume failed: engine closed")
            try:
                t = await self.node.connect(
                    peer_id, wire.RequestType.TRANSPORT, timeout=3.0)
            except (P2PError, ServerError, OSError,
                    asyncio.TimeoutError) as e:
                raise P2PError(f"reconnect for resume failed: {e}") from e
            orch.active_transports[peer_id] = t
            return t

        await TransferScheduler.run_resumable(
            transport, peer_id, data, file_info, file_id,
            throughput_bps=self._peer_throughput(peer_id),
            redial=redial, on_drop=on_drop)

    def _whole_file_job(self, orch: Orchestrator, transport, peer_id: bytes,
                        pid: bytes, path: Path, size: int):
        """One scheduled transfer: read off-loop, send (resumably), then
        post-ack bookkeeping.  An OSError on the read is isolated to this
        transfer (the file is retried next tick), not a peer failure."""
        async def job() -> None:
            data = await self._blocking(path.read_bytes)
            await self._send_resumable(orch, transport, peer_id, data,
                                       wire.FileInfoKind.PACKFILE, pid)
            self.store.add_peer_transmitted(peer_id, size)
            faults.crashpoint(_CP_PLACE_PRE)
            self.store.record_placement(pid, peer_id, size)
            faults.crashpoint(_CP_PLACE_POST)
            # delete only after ack (send.rs:277-289) AND after the
            # placement row commits: a crash between the two leaves the
            # local copy, which recover() finishes against the recorded
            # placement — the reverse order would strand acked bytes the
            # DB knows nothing about
            await self._blocking(path.unlink)
            orch.bytes_sent += size
            orch.adjust_buffer(-size)
            self._progress(bytes_transmitted=orch.bytes_sent)
        return job

    # --- erasure-coded stripe placement (erasure/) --------------------------

    @staticmethod
    def _stripe_geometry():
        """(k, m) when erasure placement is enabled, else None.

        Read per call so tests (and operators) can flip RS_K/RS_M without
        rebuilding the engine; RS_M = 0 disables striping entirely.
        """
        k, m = int(defaults.RS_K), int(defaults.RS_M)
        if k < 1 or m < 1 or k + m > 256:
            return None
        return k, m

    async def _send_stripes(self, orch: Orchestrator,
                            sched: TransferScheduler, unsent: list):
        """Place unsent packfiles as k+m shard stripes on distinct peers.

        Per packfile: skip shard indices already placed (deterministic
        encode makes re-sends byte-identical, so a retry after a crash or
        a dead peer resumes the same stripe), acquire one fresh transport
        per missing shard, put **every missing shard in flight
        concurrently** — each to its own peer, so the stripe's wall clock
        is bounded by the slowest single shard, not the sum — and delete
        the local file only once all k+m shards are acked.  Returns
        (files for the legacy whole-file path, bytes fully placed).  A
        packfile that already has a whole-file placement, or that cannot
        reach enough distinct peers this tick, is handed back for the
        legacy path — never stranded.
        """
        geom = self._stripe_geometry()
        if geom is None:
            return unsent, 0
        k, m = geom
        n = k + m
        loop = asyncio.get_running_loop()
        leftover = []
        placed_bytes = 0
        for pid, path, size in unsent:
            holders: Dict[int, bytes] = {}
            whole_placed = False
            for peer, idx in self.store.shards_for_packfile(pid):
                if idx < 0:
                    whole_placed = True
                else:
                    holders[idx] = bytes(peer)
            if whole_placed:
                leftover.append((pid, path, size))
                continue
            missing = [i for i in range(n) if i not in holders]
            if not missing:
                # fully placed by an earlier interrupted run
                await self._finish_stripe(orch, pid, path, size)
                placed_bytes += size
                continue
            shard_size = rs_stripe.HEADER_LEN + gf_cpu.shard_len(size, k)
            exclude = set(holders.values()) | self._avoid_peers
            conns = await self._get_stripe_connections(
                orch, len(missing), exclude, shard_size)
            if len(conns) < len(missing):
                leftover.append((pid, path, size))
                continue
            try:
                data = await self._blocking(path.read_bytes)
            except OSError as e:
                # never swallow the read failure: report it and hand the
                # packfile back so the next tick retries instead of the
                # stripe silently vanishing from this run
                self._log(f"packfile {bytes(pid).hex()[:8]} read failed:"
                          f" {e}; queued for retry")
                leftover.append((pid, path, size))
                continue
            # GF(2^8) matmul (device or numpy oracle): off the event loop
            containers = await loop.run_in_executor(
                None, rs_stripe.split_packfile, data, k, m, self.backend)
            for i in missing:
                await self._blocking(
                    self._save_shard_challenge_table, pid, i, containers[i])
            pairs = list(zip(missing, conns))
            tasks = [
                sched.submit(peer_id, len(containers[i]),
                             self._shard_job(orch, transport, peer_id, pid,
                                             i, containers[i]),
                             label=f"shard:{bytes(pid).hex()[:8]}:{i}")
                for i, (transport, peer_id, _free) in pairs]
            all_acked = True
            for ((i, (_t, peer_id, _f)), r) in zip(
                    pairs, await sched.gather(tasks)):
                if r.ok:
                    holders[i] = bytes(peer_id)
                else:
                    # this shard's failure stays its own: the siblings
                    # already completed to THEIR peers
                    all_acked = False
                    if isinstance(r.error, P2PError):
                        await self._drop_transport(orch, peer_id)
            if all_acked and len(holders) == n:
                await self._finish_stripe(orch, pid, path, size)
                placed_bytes += size
                if self.messenger is not None:
                    self.messenger.erasure(bytes(pid).hex(), "placed",
                                           shards=n, rebuilt=0)
            else:
                # partial stripe: retried next tick (placed shards skip)
                leftover.append((pid, path, size))
        return leftover, placed_bytes

    def _shard_job(self, orch: Orchestrator, transport, peer_id: bytes,
                   pid: bytes, index: int, container: bytes):
        """One scheduled shard transfer + its post-ack bookkeeping."""
        async def job() -> None:
            await self._send_resumable(orch, transport, peer_id, container,
                                       wire.FileInfoKind.SHARD,
                                       rs_stripe.shard_id(pid, index))
            self.store.add_peer_transmitted(peer_id, len(container))
            faults.crashpoint(_CP_PLACE_PRE)
            self.store.record_placement(pid, peer_id, len(container),
                                        shard_index=index)
            faults.crashpoint(_CP_PLACE_POST)
        return job

    async def _finish_stripe(self, orch: Orchestrator, pid: bytes,
                             path: Path, size: int) -> None:
        """Local-delete + accounting once every shard of ``pid`` is acked
        (the striped analogue of the post-ack unlink in the legacy path)."""
        faults.crashpoint(_CP_STRIPE_PRE)
        try:
            await self._blocking(path.unlink)
        except OSError:
            pass
        faults.crashpoint(_CP_STRIPE_POST)
        orch.bytes_sent += size
        orch.adjust_buffer(-size)
        self._log(f"packfile {bytes(pid).hex()[:8]} placed as "
                  f"{defaults.RS_K}+{defaults.RS_M} stripe")

    def _save_shard_challenge_table(self, pid: bytes, index: int,
                                    container: bytes) -> None:
        """Audit table keyed by the 13-byte shard id, built while the
        shard bytes are local.  Failure degrades auditing, not backup."""
        sid = rs_stripe.shard_id(pid, index)
        try:
            if not self.challenge_tables.has(sid):
                self.challenge_tables.save(sid, build_challenge_table(
                    self.backend, container,
                    count=defaults.AUDIT_CHALLENGES_PER_PACKFILE))
        except Exception as e:
            self._log(f"challenge table for shard {sid.hex()[:8]}"
                      f" failed: {e}")

    async def _get_stripe_connections(self, orch: Orchestrator, need: int,
                                      exclude: set, min_free: int) -> list:
        """Up to ``need`` transports to DISTINCT peers outside ``exclude``,
        each with ``min_free`` bytes of allowance: reuse actives first,
        then dial known peers in measured-capacity order (the same
        ordering ``find_peers_with_storage`` gives the legacy path)."""
        conns = []
        chosen = set()
        # capacity demotion applies to active transports too: an open
        # socket to a measured-flaky peer is not a reason to keep
        # placing shards on it
        demoted = self.store.placement_demoted_peers()
        for peer_id, t in list(orch.active_transports.items()):
            if len(conns) >= need:
                break
            key = bytes(peer_id)
            if key in exclude or key in chosen or key in demoted:
                continue
            peer = self.store.get_peer(key)
            if peer is not None and peer.free_storage >= min_free:
                conns.append((t, key, peer.free_storage))
                chosen.add(key)
        if len(conns) < need:
            for peer in self.store.find_peers_with_storage(
                    exclude=exclude | chosen):
                if len(conns) >= need:
                    break
                key = bytes(peer.pubkey)
                if peer.free_storage < min_free:
                    continue  # capacity-ordered now, so keep scanning:
                    # a later (slower) peer may still have the space
                if key in orch.active_transports:
                    continue  # already weighed in the reuse pass
                try:
                    t = await self.node.connect(
                        key, wire.RequestType.TRANSPORT, timeout=3.0)
                except (P2PError, ServerError, OSError,
                        asyncio.TimeoutError) as e:
                    self._log(f"dial {key.hex()[:8]} failed: {e}")
                    continue
                orch.active_transports[key] = t
                conns.append((t, key, peer.free_storage))
                chosen.add(key)
        return conns

    async def _send_index_files(self, orch, estimate, fulfilled) -> None:
        request_timer = retry.RetryTimer(retry.STORAGE_REQUEST)
        peer_wait = retry.Backoff(retry.PEER_WAIT)
        while True:
            # Re-filter by the persisted watermark every attempt so a retry
            # after a mid-batch failure never re-sends files already acked
            # (the peer's writer refuses overwrites, which would livelock).
            # Mirrors send.rs re-checking highest_sent_index per file.
            watermark = self.store.get_highest_sent_index()

            def scan(wm=watermark):
                return sorted(
                    (p for p in self._index_dir().iterdir()
                     if p.name.isdigit() and int(p.name) > wm),
                    key=lambda p: int(p.name))

            files = await self._blocking(scan)
            if not files:
                return
            transport, peer_id, _free = await self._get_peer_connection(
                orch, estimate, fulfilled, request_timer)
            if transport is None:
                await peer_wait.sleep()
                continue
            peer_wait.reset()
            request_timer.reset()
            try:
                # index files stay strictly sequential on one peer: the
                # watermark is a prefix property, so out-of-order acks
                # would let a crash skip files on resume
                for f in files:
                    num = int(f.name)
                    data = await self._blocking(f.read_bytes)
                    await transport.send_data(
                        data, wire.FileInfoKind.INDEX,
                        num.to_bytes(8, "little"))
                    self.store.set_highest_sent_index(num)
                    self.store.add_peer_transmitted(peer_id, len(data))
                return
            except P2PError:
                await self._drop_transport(orch, peer_id)

    async def _get_peer_connection(self, orch, estimate, fulfilled,
                                   request_timer, min_free: int = 1):
        """(transport, peer_id, free) — reuse, dial known, or request
        storage (send.rs:209-262).  ``min_free`` is the size of the next
        file to send: peers whose remaining allowance (plus overuse grace)
        cannot take it are skipped so the storage-request path still runs.
        ``request_timer`` throttles the storage-request branch with
        jittered backoff across consecutive dry calls (utils/retry.py).
        """
        usable = min_free - defaults.PEER_OVERUSE_GRACE // 2

        demoted = self.store.placement_demoted_peers()
        sched = getattr(self, "_transfers", None)
        for peer_id, t in list(orch.active_transports.items()):
            if bytes(peer_id) in self._avoid_peers \
                    or bytes(peer_id) in demoted:
                await self._drop_transport(orch, peer_id)
                continue
            peer = self.store.get_peer(peer_id)
            free = peer.free_storage if peer else 0
            if free > 0 and free >= usable:
                return t, peer_id, free
            if sched is not None and sched.peer_busy(peer_id):
                # too full for the NEXT file but a concurrent tick still
                # has transfers in flight on this socket: keep it open.
                # Closing here would strand the sibling's ack wait and
                # force an abort-and-resume for a send that was fine.
                continue
            await self._drop_transport(orch, peer_id)
        for peer in self.store.find_peers_with_storage(
                exclude=self._avoid_peers):
            if peer.free_storage < usable:
                continue  # capacity-ordered now, so keep scanning:
                # a later (slower) peer may still have the space
            if bytes(peer.pubkey) in orch.active_transports:
                continue  # kept-busy transport above; dialing again would
                # replace the registered socket and orphan its acks
            try:
                t = await self.node.connect(peer.pubkey,
                                            wire.RequestType.TRANSPORT,
                                            timeout=3.0)
                orch.active_transports[peer.pubkey] = t
                return t, peer.pubkey, peer.free_storage
            except (P2PError, ServerError, OSError,
                    asyncio.TimeoutError) as e:
                self._log(
                    f"dial {bytes(peer.pubkey).hex()[:8]} failed: {e}")
                continue
        # no peer available: storage request, throttled (send.rs:296-309)
        now = time.time()
        if request_timer.due(now):
            request_timer.fire(now)
            missing = max(estimate - fulfilled, 0)
            amount = min(max(missing, defaults.STORAGE_REQUEST_STEP),
                         defaults.STORAGE_REQUEST_CAP)
            # with erasure enabled, ask the matchmaker for a full stripe's
            # worth of DISTINCT peers so grants spread instead of landing
            # on one giant candidate (server caps per-candidate share)
            geom = self._stripe_geometry()
            min_peers = (geom[0] + geom[1]) if geom else 1
            try:
                await self.server.backup_storage_request(
                    amount, min_peers=min_peers)
            except Exception:
                pass
        return None, None, 0

    async def _drop_transport(self, orch, peer_id) -> None:
        t = orch.active_transports.pop(bytes(peer_id), None)
        if t is not None:
            await t.close()

    # --- storage audits (verifier side, audit/) ----------------------------

    def note_audit_due(self, peer_id: bytes) -> None:
        """Pull a peer's next audit forward (server AuditDue push)."""
        self.store.mark_audit_due(peer_id)

    async def audit_peer(self, peer_id: bytes,
                         now: Optional[float] = None) -> Optional[AuditResult]:
        """One challenge–response audit round against one peer.

        Selection burns the challenge cursor before anything is sent, the
        proof must echo our sequence number under this session's nonce
        (replays from older sessions/rounds are rejected), and the outcome
        lands in the ledger + the coordination server.  Returns None when
        the peer has nothing auditable left (tables consumed).
        """
        peer_id = bytes(peer_id)
        now = time.time() if now is None else now
        challenges, expected = select_challenges(
            self.store, self.challenge_tables, peer_id)
        if not challenges:
            from dataclasses import replace
            st = self.store.get_audit_state(peer_id)
            self.store.put_audit_state(replace(
                st, next_due=now + defaults.AUDIT_INTERVAL_S))
            return None
        try:
            t = await self.node.connect(peer_id, wire.RequestType.AUDIT,
                                        timeout=10.0)
        except (P2PError, ServerError, OSError, asyncio.TimeoutError) as e:
            st = record_miss(self.store, peer_id, now=now)
            self._audit_event(peer_id, "miss", str(e), st)
            return AuditResult(passed=False, checked=0,
                              detail=f"unreachable: {e}")
        try:
            seq = t.seq
            t.seq += 1
            await t.send_body(wire.P2PBody(
                kind=wire.P2PBodyKind.CHALLENGE,
                header=wire.P2PHeader(sequence_number=seq,
                                      session_nonce=t.session_nonce),
                challenges=tuple(challenges)))
            reply = await t.recv_body(defaults.AUDIT_PROOF_TIMEOUT_S)
        except P2PError as e:
            st = record_miss(self.store, peer_id, now=now)
            self._audit_event(peer_id, "miss", str(e), st)
            return AuditResult(passed=False, checked=0,
                              detail=f"no proof: {e}")
        finally:
            await t.close()
        if reply.kind != wire.P2PBodyKind.PROOF \
                or reply.header.sequence_number != seq:
            result = AuditResult(passed=False, checked=len(challenges),
                                 detail="bad or replayed proof body")
        else:
            result = check_proofs(challenges, expected, reply.proofs)
        if result.passed:
            st = record_pass(self.store, peer_id, now=now)
        else:
            st = record_fail(self.store, peer_id, result.detail, now=now)
        self._audit_event(peer_id, "pass" if result.passed else "fail",
                          result.detail, st)
        try:
            await self.server.audit_report(peer_id, result.passed,
                                           result.detail)
        except Exception as e:
            self._log(f"audit report upload failed: {e}")
        return result

    async def run_audit_round(self, now: Optional[float] = None) -> Dict:
        """Audit every peer whose ledger says it is due."""
        now = time.time() if now is None else now
        _AUDIT_ROUNDS.inc()
        results: Dict[bytes, AuditResult] = {}
        with obs_trace.span("engine.audit_round"):
            for peer in self.store.audit_due_peers(now):
                res = await self.audit_peer(peer, now=now)
                if res is not None:
                    results[bytes(peer)] = res
        return results

    async def audit_scheduler(self, poll_s: float = 30.0) -> None:
        """Background verifier loop; skips polls while a backup/restore
        holds the engine so audits never contend for the transports."""
        while True:
            await asyncio.sleep(poll_s)
            if self._exclusive.locked():
                continue
            try:
                await self.run_audit_round()
            except Exception as e:  # keep the loop alive across bad rounds
                self._log(f"audit round failed: {e}")

    def _audit_event(self, peer_id: bytes, outcome: str, detail: str,
                     state) -> None:
        hexid = bytes(peer_id).hex()
        msg = f"audit {outcome} for peer {hexid[:8]}"
        if detail:
            msg += f": {detail}"
        if state.demoted:
            msg += " (peer demoted)"
        self._log(msg)
        if self.messenger is not None:
            self.messenger.audit(hexid, outcome, detail=detail,
                                 demoted=state.demoted)
        if state.demoted:
            # journal the demotion so the breach explainer can rank it
            # against armed fault sites in the breach window
            obs_journal.emit("placement_demotion", peer=hexid[:8],
                            outcome=outcome, misses=state.misses)
            self._on_peer_demoted(peer_id)

    # --- peer-loss repair ----------------------------------------------------

    def _on_peer_demoted(self, peer_id: bytes) -> None:
        """Audit-ledger demotion hook: schedule a repair round.

        Fires at most one background round at a time; tests set
        ``auto_repair = False`` and drive :meth:`repair_round` explicitly.
        """
        if not self.auto_repair:
            return
        if self._repair_task is not None and not self._repair_task.done():
            return
        self._repair_task = asyncio.create_task(self._auto_repair())

    async def _auto_repair(self) -> None:
        try:
            await self.repair_round()
        except Exception as e:  # background task: log, never crash the app
            self._log(f"repair round failed: {e}")

    async def aclose(self) -> None:
        """Cancel any in-flight background repair (app shutdown)."""
        if self._repair_task is not None:
            self._repair_task.cancel()
            try:
                await self._repair_task
            except (asyncio.CancelledError, Exception):
                pass
            self._repair_task = None

    async def repair_round(self, now: Optional[float] = None) -> Dict:
        """Re-replicate packfiles orphaned by demoted or long-dark peers.

        Walks the placement rows for every peer that is audit-demoted or
        unseen past ``PEER_DARK_DEADLINE_S``, finds the packfiles whose
        every replica lived on lost peers, forgets those blobs in the
        index, and re-packs them from the local source tree — CDC + blake3
        are deterministic, so the unchanged source reproduces exactly the
        forgotten blobs while everything else dedups away.  The fresh
        packfiles go to surviving peers through the normal send loop; only
        then are the dead placements retired and the reclaimed allocation
        reported to the coordination server.
        """
        if self._exclusive.locked():
            _BUSY_REJECTS.inc(op="repair")
            raise EngineError("a backup or restore is already running")
        async with self._exclusive:
            _REPAIR_ROUNDS.inc()
            with obs_trace.span("engine.repair_round"):
                return await self._repair_round_locked(now)

    def _lost_peers(self, now: float) -> set:
        """Peers holding placements that are demoted or dark past
        deadline — the shared definition in obs/invariants.py, so the
        repair plane and the durability monitor can never disagree."""
        return obs_invariants.lost_peers(self.store, now)

    async def _repair_round_locked(self, now: Optional[float]) -> Dict:
        now = time.time() if now is None else now
        lost = self._lost_peers(now)
        report: Dict = {"peers": {}, "packfiles": 0, "bytes_lost": 0,
                        "bytes_replaced": 0, "blobs": 0,
                        "shards_rebuilt": 0}
        # a packfile is orphaned only if EVERY replica is on a lost peer;
        # a lost erasure shard whose stripe keeps live holders goes to the
        # sourceless rebuild path instead (no local source tree needed)
        per_peer: Dict[bytes, list] = {}
        orphaned: Dict[bytes, int] = {}
        stripe_lost: Dict[bytes, Dict[int, tuple]] = {}
        for peer in lost:
            rows = self.store.shard_placements_for_peer(peer)
            per_peer[peer] = rows
            for pid, size, idx in rows:
                pidb = bytes(pid)
                holders = {bytes(p)
                           for p in self.store.peers_for_packfile(pid)}
                if holders <= lost:
                    if idx >= 0:
                        orphaned[pidb] = orphaned.get(pidb, 0) + size
                    else:
                        orphaned[pidb] = size
                elif idx >= 0:
                    stripe_lost.setdefault(pidb, {})[idx] = (peer, size)
                # idx < 0 with live holders: another whole replica
                # survives — nothing to rebuild, the row just retires
        unsent_pids = {bytes(pid)
                       for pid, _path, _size in self._unsent_packfiles()}
        self._queue_underplaced_stripes(stripe_lost, orphaned, lost,
                                        unsent_pids)
        if not lost and not stripe_lost and not unsent_pids:
            return report
        shards_rebuilt = 0
        shard_bytes_replaced = 0
        if stripe_lost:
            shards_rebuilt, shard_bytes_replaced, unrebuildable = \
                await self._rebuild_lost_shards(stripe_lost, lost)
            for pidb in unrebuildable:
                # fewer than k shards survive and no whole copy: only the
                # local source can bring the data back — re-pack fallback
                orphaned[pidb] = orphaned.get(pidb, 0) + sum(
                    s for _, s in stripe_lost[pidb].values())
        lost_hashes = self.index.forget_packfiles(orphaned)
        # the dead packfiles' audit tables go with them (whole-file AND
        # per-shard): challenge state must not outlive the data it names
        self.challenge_tables.forget(orphaned)
        bytes_lost = sum(orphaned.values()) + sum(
            s for pidb, lm in stripe_lost.items() if pidb not in orphaned
            for _, s in lm.values())
        self._log(f"repair: {len(lost)} lost peer(s), "
                  f"{len(orphaned)} orphaned packfile(s), "
                  f"{shards_rebuilt} shard(s) rebuilt sourcelessly, "
                  f"{len(lost_hashes)} blob(s) to re-replicate")
        bytes_replaced = 0
        # also run the pipeline when a previous failed round left forgotten
        # blobs re-packed but unsent on disk: everything dedups, the
        # leftovers drain, and only then do the placements retire
        if lost_hashes or self._unsent_packfiles():
            # the device dedup front mirrors the index: rebuild its table
            # from the pruned map so re-packed blobs are not misclassified
            # as duplicates
            if self.device_dedup is not None:
                self.device_dedup = self._make_device_dedup(
                    self.device_dedup.device, self.device_dedup.n_shards)
            self._avoid_peers = set(lost)
            try:
                bytes_replaced = await self._repack_and_send(bytes_lost)
            finally:
                self._avoid_peers = set()
        # placements retire only after the replacement copies are acked;
        # a failed round leaves the rows so the next round retries (the
        # forget is idempotent and the re-pack dedups what already went)
        from dataclasses import replace
        for peer in lost:
            retired = self.store.retire_placements(peer)
            st = self.store.get_audit_state(peer)
            if not st.demoted:
                # dark-but-never-audited peers: persist the demotion so
                # they stay out of placement after this round
                self.store.put_audit_state(replace(
                    st, demoted=True,
                    last_result="dark: placements repaired away"))
            peer_lost = sum(s for pid, s, _idx in per_peer[peer]
                            if bytes(pid) in orphaned)
            report["peers"][bytes(peer).hex()] = {
                "placements_retired": retired, "bytes_lost": peer_lost}
            try:
                await self.server.repair_report(
                    peer, packfiles_lost=len(orphaned),
                    bytes_lost=peer_lost, bytes_replaced=bytes_replaced)
            except Exception as e:
                self._log(f"repair report for {bytes(peer).hex()[:8]} "
                          f"failed: {e}")
        report.update(packfiles=len(orphaned), bytes_lost=bytes_lost,
                      bytes_replaced=bytes_replaced + shard_bytes_replaced,
                      blobs=len(lost_hashes), shards_rebuilt=shards_rebuilt)
        self.store.add_event(EVENT_REPAIR, {
            "peers": [bytes(p).hex() for p in lost],
            "packfiles": len(orphaned), "bytes_lost": bytes_lost,
            "bytes_replaced": bytes_replaced + shard_bytes_replaced,
            "shards_rebuilt": shards_rebuilt})
        self._log(f"repair complete: {bytes_replaced} bytes re-replicated")
        return report

    def _queue_underplaced_stripes(self, stripe_lost: Dict, orphaned: Dict,
                                   lost: set, unsent_pids: set) -> None:
        """Queue stripes that are short a shard with NO lost row to blame
        — the scar a partially re-homed repair round leaves ("stripe
        stays degraded until peers join").  Without this, no later round
        would ever look at them: the dead rows are already retired, so
        the lost-peer walk comes up empty while the stripe sits one
        failure closer to unrestorable.  The missing indexes take the
        same sourceless rebuild path; the synthetic rows carry no dead
        peer to retire (``b""``) and a sibling shard's size as the
        estimate.  Stripes whose packfile still sits locally unsent
        (``unsent_pids``) are skipped — the leftover drain finishes them
        from the local bytes, which is cheaper than pulling k shards.
        """
        n = defaults.RS_K + defaults.RS_M
        by_pid: Dict[bytes, list] = {}
        for pid, peer, size, idx, _sent in self.store.all_placements():
            if idx >= 0:
                by_pid.setdefault(bytes(pid), []).append(
                    (bytes(peer), int(size), int(idx)))
        for pidb, rows in by_pid.items():
            if pidb in orphaned or pidb in unsent_pids:
                continue
            live = {idx for peer, _s, idx in rows if peer not in lost}
            if not live:
                continue  # every row lost: the orphan/repack walk owns it
            expected = max(n, max(idx for _p, _s, idx in rows) + 1)
            queued = stripe_lost.get(pidb, {})
            missing = set(range(expected)) - live - set(queued)
            if not missing:
                continue
            est = max(s for _p, s, _i in rows)
            entry = stripe_lost.setdefault(pidb, {})
            for idx in sorted(missing):
                entry[idx] = (b"", est)

    async def _rebuild_lost_shards(self, stripe_lost: Dict, lost: set):
        """Sourceless shard repair on the restore data plane: pull the k
        survivor shards each damaged stripe needs, shard-granular
        (RESTORE_FETCH through the same download lanes a restore uses —
        fastest holders first, hedged stalls, re-queue on failure),
        staged privately; decode + re-encode the lost rows —
        byte-identical, so the pre-computed challenge tables stay valid —
        and place them on fresh peers.  Stripes are processed in the
        durability monitor's at-risk order (fewest clean survivors
        first), so the data closest to unrestorable re-homes first.  The
        local source tree is never touched.  Returns ``(shards rebuilt,
        bytes placed, pids needing the re-pack-from-source fallback)``.
        """
        staging = self.store.data_base / "repair_staging"
        shutil.rmtree(staging, ignore_errors=True)
        staging.mkdir(parents=True, exist_ok=True)
        writer = RestoreFilesWriter(self.store, base=staging)
        survivors: Dict[bytes, list] = {}
        for pidb in stripe_lost:
            survivors[pidb] = [
                (bytes(p), i)
                for p, i in self.store.shards_for_packfile(pidb)
                if i >= 0 and bytes(p) not in lost]
        at_risk = sorted(stripe_lost,
                         key=lambda pidb: len(survivors[pidb]))
        pull_sched = TransferScheduler(messenger=self.messenger,
                                       peer_stats=self.peer_stats)
        streamed: set = set()
        for pidb in at_risk:
            est = max((s for _p, s in stripe_lost[pidb].values()),
                      default=0)
            shard_map = {i: (p, est) for p, i in survivors[pidb]}
            got = 0
            if shard_map:
                got = await self._pull_stripe(pidb, shard_map, writer,
                                              pull_sched)
            if got < min(defaults.RS_K, len(shard_map)):
                # shard pulls came up short: fall back to full
                # RESTORE_ALL streams from this stripe's untapped holders
                # (also the interop path for peers predating the fetch
                # protocol)
                for peer_id in sorted({p for p, _i in survivors[pidb]}
                                      - streamed):
                    try:
                        t = await self.node.connect(
                            peer_id, wire.RequestType.RESTORE_ALL,
                            timeout=self._dial_budget(peer_id))
                        try:
                            await Receiver(
                                t, writer.sink,
                                part_sink=writer.sink_part,
                                resume_query=writer.resume_offer).run()
                        finally:
                            await t.close()
                        streamed.add(peer_id)
                    except (P2PError, ServerError, OSError,
                            asyncio.TimeoutError) as e:
                        self._log(f"repair fetch from {peer_id.hex()[:8]}"
                                  f" failed: {e}")
        rebuilt = 0
        placed_bytes = 0
        unrebuildable = []
        loop = asyncio.get_running_loop()
        orch = Orchestrator()  # transport bookkeeping for fresh placements
        sched = TransferScheduler(messenger=self.messenger,
                                  peer_stats=self.peer_stats)

        def read_staged(d: Path) -> list:
            if not d.is_dir():
                return []
            return [f.read_bytes() for f in sorted(d.iterdir())
                    if f.is_file()]

        try:
            for pidb in at_risk:
                lost_map = stripe_lost[pidb]
                shard_dir = staging / "shard" / pidb.hex()
                blobs = await self._blocking(read_staged, shard_dir)
                missing = sorted(lost_map)
                try:
                    new_shards = await loop.run_in_executor(
                        None, rs_stripe.rebuild_shards, blobs, missing,
                        self.backend)
                except rs_stripe.StripeError as e:
                    self._log(f"stripe {pidb.hex()[:8]} not rebuildable:"
                              f" {e}")
                    live_whole = any(
                        i < 0 and bytes(p) not in lost
                        for p, i in self.store.shards_for_packfile(pidb))
                    if not live_whole:
                        unrebuildable.append(pidb)
                    continue
                holders = {bytes(p) for p, _i
                           in self.store.shards_for_packfile(pidb)}
                conns = await self._get_stripe_connections(
                    orch, len(missing), holders | lost | self._avoid_peers,
                    max(len(c) for c in new_shards.values()))
                pairs = list(zip(missing, conns))
                tasks = []
                for idx, (transport, peer_id, _free) in pairs:
                    container = new_shards[idx]
                    await self._blocking(self._save_shard_challenge_table,
                                         pidb, idx, container)
                    tasks.append(sched.submit(
                        peer_id, len(container),
                        self._repair_shard_job(orch, transport, peer_id,
                                               pidb, idx, container,
                                               lost_map[idx][0]),
                        label=f"repair:{pidb.hex()[:8]}:{idx}"))
                placed_here = 0
                for ((idx, (_t, peer_id, _f)), r) in zip(
                        pairs, await sched.gather(tasks)):
                    if r.ok:
                        rebuilt += 1
                        _SHARDS_REBUILT.inc()
                        placed_here += 1
                        placed_bytes += len(new_shards[idx])
                    elif isinstance(r.error, P2PError):
                        await self._drop_transport(orch, peer_id)
                if placed_here < len(missing):
                    self._log(f"stripe {pidb.hex()[:8]}: re-homed only "
                              f"{placed_here}/{len(missing)} shard(s); "
                              "stripe stays degraded until peers join")
                if placed_here and self.messenger is not None:
                    self.messenger.erasure(pidb.hex(), "rebuilt",
                                           shards=len(missing),
                                           rebuilt=placed_here)
        finally:
            for peer_id in list(orch.active_transports):
                await self._drop_transport(orch, peer_id)
            await self._blocking(
                lambda: shutil.rmtree(staging, ignore_errors=True))
        return rebuilt, placed_bytes, unrebuildable

    def _repair_shard_job(self, orch, transport, peer_id: bytes,
                          pidb: bytes, idx: int, container: bytes,
                          dead_peer: bytes):
        """One scheduled replacement-shard transfer; on ack the dead row
        retires immediately instead of waiting for the end-of-round
        retirement."""
        async def job() -> None:
            await self._send_resumable(orch, transport, peer_id, container,
                                       wire.FileInfoKind.SHARD,
                                       rs_stripe.shard_id(pidb, idx))
            self.store.add_peer_transmitted(peer_id, len(container))
            faults.crashpoint(_CP_REHOME_PRE)
            self.store.record_placement(pidb, peer_id, len(container),
                                        shard_index=idx)
            # record-then-retire: a crash between the two leaves BOTH rows
            # (over-placed, cleaned by the next repair round's retirement),
            # never neither (data on a dead peer with no replacement row)
            faults.crashpoint(_CP_REHOME_POST)
            self.store.retire_placement(pidb, dead_peer)
        return job

    async def _repack_and_send(self, bytes_lost: int) -> int:
        """Re-pack forgotten blobs from source and send to fresh peers.

        Same pack ∥ send machinery as a backup, minus the snapshot upload:
        the snapshot hash is unchanged (the data is), only placement moves.
        """
        root = Path(self.store.get_backup_path() or "")
        if not root.is_dir():
            raise EngineError(
                f"cannot repair: backup path {root} is not a directory")
        orch = self.orchestrator = Orchestrator()
        loop = asyncio.get_running_loop()
        orch.set_buffer(self._buffer_bytes())
        estimate = max(bytes_lost, 1)
        repair_tid = obs_trace.current_trace_id()

        def pack_thread() -> None:
            writer = PackfileWriter(
                self.keys, self._pack_dir(),
                on_packfile=self._on_packfile_threadsafe(loop),
                seal_workers=defaults.PACK_SEAL_WORKERS)
            packer = DirPacker(self.backend, writer, self.index,
                               progress=self._pack_progress,
                               should_pause=orch.block_if_paused,
                               dedup_index=self.device_dedup)
            try:
                with obs_trace.bind(repair_tid), \
                        tracing.span("engine.repair_pack"):
                    packer.pack(root)
            finally:
                writer.shutdown()

        pack_fut = loop.run_in_executor(None, pack_thread)
        send_task = asyncio.create_task(self._send_loop(orch, estimate))
        try:
            await pack_fut
            orch.packing_completed = True
            orch.notify_packfile()
            await self._blocking(self.index.flush)
        except BaseException:
            # BaseException on purpose: an injected CrashInjected (and a
            # cancel of this coroutine) must still tear down the send
            # loop instead of leaving it spinning against a dead backup
            orch.failed = True
            send_task.cancel()
            raise
        try:
            await send_task
        except asyncio.CancelledError:
            raise EngineError("repair send pipeline cancelled")
        return orch.bytes_sent

    # --- restore (backup/mod.rs:117-192) -----------------------------------

    async def run_restore(self, dest: Optional[Path] = None) -> Path:
        if self._exclusive.locked():
            _BUSY_REJECTS.inc(op="restore")
            raise EngineError("a backup or restore is already running")
        async with self._exclusive:
            with obs_trace.span("engine.restore"):
                try:
                    out = await self._run_restore_locked(dest)
                except BaseException:
                    _RESTORE_RUNS.inc(outcome="failed")
                    raise
            _RESTORE_RUNS.inc(outcome="ok")
            return out

    async def _run_restore_locked(self, dest: Optional[Path]) -> Path:
        last = self.store.last_event_time(EVENT_RESTORE_REQUEST)
        if last is not None and \
                time.time() - last < defaults.RESTORE_REQUEST_THROTTLE_S:
            raise EngineError("restore requested too recently")
        try:
            info = await self.server.backup_restore()
        except NoBackups:
            raise EngineError("no snapshot recorded on server")
        if info.snapshot_hash is None:
            raise EngineError("no snapshot recorded on server")
        # throttle only once a snapshot is actually negotiated: a
        # NoBackups or network error must not burn the user's one
        # restore-request slot per window
        self.store.add_event(EVENT_RESTORE_REQUEST, {})
        peers = [bytes.fromhex(p) for p in info.peers]
        if not peers:
            raise EngineError("no peers hold our data")
        writer = RestoreFilesWriter(self.store)
        plan = self._restore_plan()
        streamed: set = set()
        if plan is not None:
            # shard-granular pull plan over the local placement map:
            # each stripe from its k fastest holders with hedged spares,
            # whole-copy peers as single batched pulls
            stripes, whole, known = plan
            await self._pull_striped_restore(stripes, whole, writer)
            legacy_peers = [p for p in peers if p not in known]
        else:
            # no placement map (disaster recovery onto a fresh identity):
            # only the negotiated peer list exists, so every peer pushes
            # its whole stream (and old peers only speak this path)
            legacy_peers = list(peers)
        if legacy_peers:
            streamed = await self._pull_restore_all(legacy_peers, writer)
        # erasure assembly BEFORE coverage is judged: any k valid shards
        # of a stripe reconstruct its packfile into the pack tree, so up
        # to m dark peers per stripe cost nothing
        await self._assemble_restored_stripes()
        # Coverage decides success, not per-peer completion: shard pulls
        # deliberately skip n-k holders per stripe, and a negotiated peer
        # that stores nothing for us (the matcher's save/notify crash
        # window in net/server.py) refuses the dial while the data the
        # others returned still covers the snapshot.
        need_check = plan is not None or len(streamed) < len(legacy_peers)
        if need_check:
            ctx = self._restored_ctx()
            gap = self._restored_coverage_gap(info.snapshot_hash, ctx)
            if gap is not None and plan is not None:
                # fetch-plane shortfall: fall back to full RESTORE_ALL
                # streams from every peer that has not streamed yet
                fallback = [p for p in peers if p not in streamed]
                if fallback:
                    self._log("restore coverage gap after shard pulls;"
                              " falling back to full streams")
                    streamed |= await self._pull_restore_all(fallback,
                                                             writer)
                    await self._assemble_restored_stripes()
                    ctx = self._restored_ctx()
                    gap = self._restored_coverage_gap(info.snapshot_hash,
                                                      ctx)
            if gap is not None:
                missing = [p for p in peers if p not in streamed]
                raise EngineError(
                    "restore incomplete; no stream from: "
                    + ", ".join(p.hex()[:8] for p in missing)
                    + f"; first missing blob {gap.hex()}")
        else:
            ctx = None
        path = self._unpack_restored(info.snapshot_hash, dest, ctx)
        # the staging buffer is deleted only after a successful unpack
        # (backup/mod.rs:180); a failed unpack keeps it for retry/forensics
        shutil.rmtree(self.store.restore_dir(), ignore_errors=True)
        return path

    # --- restore data plane: the pull planner (docs/transfer.md) -----------

    def _restore_plan(self):
        """``(stripes, whole, known_peers)`` from the local placement map,
        or None when the map is empty and only the legacy full-stream
        path can run.  ``stripes`` maps pid -> shard index -> (holder,
        size); ``whole`` maps peer -> pid -> size for packfiles with no
        stripe rows (when both exist the striped pull is preferred — the
        whole copy stays a coverage-gap fallback source)."""
        stripes: Dict[bytes, Dict[int, tuple]] = {}
        whole_rows: Dict[bytes, Dict[bytes, int]] = {}
        known: set = set()
        for pid, peer, size, idx, _sent in self.store.all_placements():
            pidb, peerb = bytes(pid), bytes(peer)
            known.add(peerb)
            if idx >= 0:
                stripes.setdefault(pidb, {})[int(idx)] = (peerb, int(size))
            else:
                whole_rows.setdefault(peerb, {})[pidb] = int(size)
        if not stripes and not whole_rows:
            return None
        whole = {
            peer: {pid: s for pid, s in pids.items() if pid not in stripes}
            for peer, pids in whole_rows.items()}
        whole = {peer: pids for peer, pids in whole.items() if pids}
        return stripes, whole, known

    @staticmethod
    def _restore_dest(writer: RestoreFilesWriter,
                      file_info: wire.FileInfoKind, file_id: bytes) -> Path:
        """Where ``writer.sink`` lands one file — the puller's existence
        check for 'did the named want actually come back'."""
        if file_info == wire.FileInfoKind.INDEX:
            num = int.from_bytes(bytes(file_id)[:8], "little")
            return writer.dir / "index" / f"{num:06d}"
        if file_info == wire.FileInfoKind.SHARD:
            pid, idx = bytes(file_id)[:-1], bytes(file_id)[-1]
            return writer.dir / "shard" / pid.hex() / f"{idx:03d}"
        h = bytes(file_id).hex()
        return writer.dir / "pack" / h[:2] / h

    def _fetch_job(self, peer_id: bytes, wants: list,
                   writer: RestoreFilesWriter, size_hint: int):
        """One RESTORE_FETCH pull as a schedulable download: connect
        under the adaptive dial budget, name the wants, receive under the
        adaptive transfer deadline, then verify every named want landed
        (a gap raises, so the scheduler re-queues it elsewhere).  Returns
        the bytes received for the estimators."""
        peer_id = bytes(peer_id)
        paths = [self._restore_dest(writer, k, f)
                 for k, f in wants if f]

        async def job() -> int:
            if self.node is None:
                raise P2PError("engine closed")
            deadline = adaptive_deadline(size_hint,
                                         self._peer_throughput(peer_id))
            t = await self.node.connect(
                peer_id, wire.RequestType.RESTORE_FETCH,
                timeout=self._dial_budget(peer_id))
            try:
                await self.node.request_fetch(t, wants)
                await asyncio.wait_for(
                    Receiver(t, writer.sink, part_sink=writer.sink_part,
                             resume_query=writer.resume_offer).run(),
                    deadline)
            finally:
                await t.close()

            def landed() -> int:
                got = 0
                for p in paths:
                    if not p.exists():
                        raise P2PError(
                            f"peer {peer_id.hex()[:8]} did not return"
                            f" {p.name}")
                    got += p.stat().st_size
                return got

            return await self._blocking(landed)
        return job

    async def _pull_stripe(self, pidb: bytes, shard_map: Dict,
                           writer: RestoreFilesWriter,
                           sched: TransferScheduler) -> int:
        """Pull one stripe's shards k-of-n: the k fastest holders are the
        primaries, the rest are spares — a primary that stalls past the
        hedge fraction of its adaptive deadline races a redundant spare
        shard, and an outright failure re-queues behind the remaining
        spares.  Returns the number of shards landed (≥ k restores the
        stripe; fewer surfaces later as a coverage gap)."""
        k = min(defaults.RS_K, len(shard_map))
        ranked = sorted(shard_map.items(),
                        key=lambda kv: self._pull_rate(kv[1][0]),
                        reverse=True)
        primaries, spares = ranked[:k], ranked[k:]
        spare_iter = iter(spares)
        delivered: list = []

        def submit_one(idx: int, holder: bytes, size: int):
            sid = rs_stripe.shard_id(pidb, idx)
            wants = [(wire.FileInfoKind.SHARD, sid)]
            return sched.submit_pull(
                holder, size, self._fetch_job(holder, wants, writer, size),
                label=f"restore:shard:{pidb.hex()[:8]}:{idx}")

        async def one_primary(idx: int, holder: bytes, size: int):
            primary = submit_one(idx, holder, size)
            hedge_after = max(
                0.05, float(defaults.RESTORE_HEDGE_DEADLINE_FRACTION)
                * adaptive_deadline(size, self._peer_throughput(holder)))

            def spawn_hedge():
                nxt = next(spare_iter, None)
                if nxt is None:
                    return None
                s_idx, (s_holder, s_size) = nxt
                return submit_one(s_idx, s_holder, s_size)

            return await sched.pull_hedged(primary, spawn_hedge,
                                           hedge_after)

        results = await asyncio.gather(
            *(one_primary(idx, holder, size)
              for idx, (holder, size) in primaries),
            return_exceptions=True)
        for res in results:
            if isinstance(res, BaseException):
                self._log(f"stripe {pidb.hex()[:8]} pull error: {res}")
            elif res is not None and res.ok:
                delivered.append(res.peer_id)
        # re-queue the shortfall behind the remaining (healthier-ranked)
        # spares, one at a time — failures here are cheap and bounded
        while len(delivered) < k:
            nxt = next(spare_iter, None)
            if nxt is None:
                break
            s_idx, (s_holder, s_size) = nxt
            res = await submit_one(s_idx, s_holder, s_size)
            if res.ok:
                delivered.append(res.peer_id)
        if delivered:
            RESTORE_SOURCES.observe(len(set(delivered)))
        if len(delivered) < k:
            self._log(f"stripe {pidb.hex()[:8]}: only {len(delivered)}/{k}"
                      " shard(s) pulled; relying on fallback coverage")
        return len(delivered)

    async def _pull_striped_restore(self, stripes: Dict, whole: Dict,
                                    writer: RestoreFilesWriter) -> None:
        """Execute the pull plan through one unified scheduler: stripe
        pulls, whole-copy batch pulls, and an index sweep (index files
        have no placement rows, so every distinct holder is asked once
        for everything it has)."""
        sched = TransferScheduler(messenger=self.messenger,
                                  peer_stats=self.peer_stats)
        tasks = []
        for peer, pids in sorted(whole.items()):
            wants = [(wire.FileInfoKind.PACKFILE, pid)
                     for pid in sorted(pids)]
            size = sum(pids.values())
            tasks.append(sched.submit_pull(
                peer, size, self._fetch_job(peer, wants, writer, size),
                label=f"restore:whole:{peer.hex()[:8]}"))
        holders = {h for m in stripes.values() for h, _s in m.values()}
        for peer in sorted(set(whole) | holders):
            tasks.append(sched.submit_pull(
                peer, 0,
                self._fetch_job(peer, [(wire.FileInfoKind.INDEX, b"")],
                                writer, 0),
                label=f"restore:index:{peer.hex()[:8]}"))
        stripe_tasks = [
            asyncio.ensure_future(
                self._pull_stripe(pidb, shard_map, writer, sched))
            for pidb, shard_map in sorted(stripes.items())]
        await asyncio.gather(*tasks, *stripe_tasks, return_exceptions=True)
        self._log(
            f"restore pull plan done: {len(stripes)} stripe(s),"
            f" {len(whole)} whole-copy peer(s),"
            f" {sched.bytes_pulled} byte(s) pulled")

    async def _pull_restore_all(self, peers: list,
                                writer: RestoreFilesWriter) -> set:
        """Legacy full-stream fan-out (RESTORE_ALL): every peer pushes
        everything it holds for us.  Returns the peers whose stream
        completed."""
        streamed: set = set()

        async def pull(peer_id: bytes) -> None:
            t = await self.node.connect(peer_id,
                                        wire.RequestType.RESTORE_ALL,
                                        timeout=self._dial_budget(peer_id))
            try:
                await Receiver(t, writer.sink,
                               part_sink=writer.sink_part,
                               resume_query=writer.resume_offer).run()
            finally:
                await t.close()
            streamed.add(peer_id)
            self._log(f"peer {peer_id.hex()[:8]} restore stream complete")

        results = await asyncio.gather(*(pull(p) for p in peers),
                                       return_exceptions=True)
        for peer_id, res in zip(peers, results):
            if isinstance(res, BaseException):
                self._log(f"restore from {peer_id.hex()[:8]} failed: {res}")
        return streamed

    async def _assemble_restored_stripes(self) -> None:
        """Rebuild packfiles from erasure shards in the restore staging
        buffer (restore_dir/shard -> restore_dir/pack); best-effort — a
        stripe with fewer than k valid shards is logged and surfaces later
        as a coverage gap, exactly like a missing packfile."""
        restore_dir = self.store.restore_dir()
        shard_root = restore_dir / "shard"
        if not shard_root.is_dir():
            return
        done, failed = await asyncio.get_running_loop().run_in_executor(
            None, rs_stripe.assemble_tree, shard_root,
            restore_dir / "pack", self.backend)
        if done:
            self._log(f"assembled {len(done)} packfile(s) from erasure"
                      " shards")
            if self.messenger is not None:
                self.messenger.erasure("restore", "assembled",
                                       shards=len(done), rebuilt=len(done))
        for pid, reason in failed:
            self._log(f"stripe {bytes(pid).hex()[:8]} not assembled:"
                      f" {reason}")

    def _restored_ctx(self):
        """(index, reader, resolve) over the restore staging buffer."""
        restore_dir = self.store.restore_dir()
        index = BlobIndex(self.keys, restore_dir / "index")
        index.load()
        reader = PackfileReader(self.keys, restore_dir / "pack")
        if len(index) == 0:  # no/partial index: rebuild from headers
            index.rebuild_from_packfiles(reader, restore_dir / "pack")
        # lazily built from packfile headers when the loaded index points
        # at a packfile that didn't come back (e.g. it was retired by a
        # repair round but an old index file still names it)
        fallback: dict = {}

        def resolve(h):
            pid = index.lookup(h)
            if pid is not None:
                try:
                    return reader.get_blob(pid, h)
                except Exception:
                    pass
            if "index" not in fallback:
                fb = BlobIndex(self.keys, restore_dir / "index")
                fb.rebuild_from_packfiles(reader, restore_dir / "pack")
                fallback["index"] = fb
            pid2 = fallback["index"].lookup(h)
            if pid2 is None or pid2 == pid:
                raise EngineError(f"blob {bytes(h).hex()} not restored")
            return reader.get_blob(pid2, h)

        return index, reader, resolve

    def _restored_coverage_gap(self, snapshot_hash: bytes, ctx=None):
        from .snapshot.unpacker import snapshot_coverage_gap
        _index, _reader, resolve = ctx or self._restored_ctx()

        def retrievable(h):
            # An index entry alone is NOT coverage: all index files may have
            # landed on a surviving peer while the packfile holding the blob
            # was on the failed one.  Actually read + decrypt the blob.
            try:
                resolve(h)
                return True
            except Exception:
                return False

        return snapshot_coverage_gap(resolve, retrievable, snapshot_hash)

    def _unpack_restored(self, snapshot_hash: bytes,
                         dest: Optional[Path], ctx=None) -> Path:
        from .snapshot.unpacker import DirUnpacker
        _index, _reader, resolve = ctx or self._restored_ctx()
        dest = Path(dest or (self.store.get_backup_path() or ""))
        DirUnpacker(resolve, progress=self._pack_progress).unpack(
            snapshot_hash, dest)
        self._log(f"restore complete into {dest}")
        return dest
