"""TieredDedupIndex: hot device probe over the cold LSM store.

Counterpart of ``backuwup_tpu/dedupstore/tiered.py``.  The reference reads
its shard count from a JAX mesh (``mesh.shape[axis]``); here the shards
live on one device and the count is ``n_shards``, as in the port's
:class:`~backuwup_tpu_torch.snapshot.device_dedup.MeshDedupIndex`.  On a
CUDA device every table call (create, insert, growth, dump) runs K5
(``csrc/dedup_probe.cu``) or raises.

Drop-in for :class:`~backuwup_tpu_torch.snapshot.device_dedup.MeshDedupIndex`
(same ``classify_dispatch`` / ``resolve_hints`` / ``classify_insert``
interface, same ``n_shards``/``device``/``host``/``capacity``/``sharded``
attributes) with one semantic shift: the hot
:class:`~backuwup_tpu_torch.ops.dedup_index.ShardedDedupIndex` is a *partial*
cache.  A device hit is still authoritative ("resident before this
batch"), but a device miss only means "not in HBM" — the per-shard
overflow/found-flag machinery the pipeline already downloads per
batch doubles as the miss filter, and only those flagged lanes fall
through to :class:`~backuwup_tpu_torch.dedupstore.cold.ColdFingerprintStore`
in one vectorized batch.  The hot path stays free of per-batch host
round trips (FastCDC's system argument, PAPERS.md: never stall the
pipeline around the chunker).

Budget discipline: the hot table's device bytes (``slots x 20 x shards``)
never exceed ``DEDUP_HBM_BUDGET_BYTES``.  When insert pressure would
force a 4x growth past the cap, :meth:`_demote` spills the
least-recently-probed residents to the cold store — durably
(run commit) *before* the hot table drops them — and rebuilds through
the same migration path a growth would use.  Promotion is the inverse:
a probe-frequency clock over dispatch windows re-pins cold keys that
keep getting hit back into HBM.

Correctness invariant (the bit-identity gate): ``hot ∪ cold`` always
covers every fingerprint the :class:`BlobIndex` authority knows, so
device-miss + cold-miss ⇒ genuinely new, and device hits only ever name
keys the authority knows (junk fallback keys aside, at the same 2^-128
odds the 128-bit truncation already accepts).
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .. import defaults
from ..obs import profile as obs_profile
from ..ops.dedup_index import (
    DedupIndexFull,
    ShardedDedupIndex,
    hashes_to_queries,
)
from ..snapshot.device_dedup import (
    _SEED_BATCH,
    MeshDedupIndex,
    _next_pow2,
)
from .cold import ColdFingerprintStore

# 16-byte truncated key + u32 value per hot slot
SLOT_BYTES = 20


class TieredDedupIndex(MeshDedupIndex):
    """Budget-capped MeshDedupIndex with a cold LSM fall-through."""

    def __init__(self, host_index, n_shards: int = 1,
                 capacity: Optional[int] = None, device=None, *,
                 cold_dir: Path,
                 hbm_budget_bytes: Optional[int] = None,
                 clock_windows: Optional[int] = None,
                 promote_min_hits: Optional[int] = None,
                 memtable_limit: Optional[int] = None,
                 compact_fanin: Optional[int] = None):
        self.hbm_budget_bytes = int(
            hbm_budget_bytes or defaults.DEDUP_HBM_BUDGET_BYTES)
        self.clock_windows = int(
            clock_windows or defaults.DEDUP_TIER_CLOCK_WINDOWS)
        self.promote_min_hits = int(
            promote_min_hits or defaults.DEDUP_TIER_PROMOTE_MIN_HITS)
        self.cold = ColdFingerprintStore(
            cold_dir, memtable_limit=memtable_limit,
            compact_fanin=compact_fanin)
        self._windows = 0
        self._saw_dispatch = False
        self._cold_hits: Dict[bytes, int] = {}
        self._promote_queue: Dict[bytes, int] = {}
        # probe-recency clock: fingerprint -> None, most recent last;
        # demotion keeps the newest entries, so its size cap doubles as
        # the hot working-set estimate
        self._recent: "OrderedDict[bytes, None]" = OrderedDict()
        known = len(host_index) + host_index.queued_count
        need = max(defaults.DEDUP_SHARD_CAPACITY,
                   _next_pow2(4 * max(known, 1) // max(n_shards, 1)))
        cap = min(capacity or need, self._max_capacity(n_shards))
        super().__init__(host_index, n_shards, capacity=cap, device=device)

    # --- capacity / budget ---------------------------------------------------

    def _max_capacity(self, n_shards: int) -> int:
        """Largest pow2 per-shard capacity under the HBM budget (floor
        of 8 slots/shard so a tiny budget still yields a working table)."""
        per = self.hbm_budget_bytes // (SLOT_BYTES * max(n_shards, 1))
        cap = 1
        while cap * 2 <= per:
            cap *= 2
        return max(cap, 8)

    @property
    def hbm_table_bytes(self) -> int:
        """Device bytes the hot fingerprint table occupies, all shards."""
        return self.n_shards * self.capacity * SLOT_BYTES

    @property
    def _pressure(self) -> bool:
        """True once the tier split is live: the cold store holds keys,
        or the next 4x growth would cross the budget (so the next Full
        demotes).  Until then the index behaves exactly like the parent
        and the per-batch clock/cold bookkeeping — recency touches, cold
        lookups, heat counters — is skipped wholesale: recency only
        matters for picking demotion victims, and the first demotion's
        arbitrary pick is corrected by the very next touched batches."""
        return (len(self.cold) > 0 or
                self.n_shards * self.capacity * 4 * SLOT_BYTES
                > self.hbm_budget_bytes)

    def _note_hbm(self) -> None:
        obs_profile.tier_hbm_bytes(self.hbm_table_bytes)

    # --- seeding -------------------------------------------------------------

    def _rebuild(self) -> None:
        """Seed hot up to a 50% fill ceiling; everything else — and
        everything the persisted cold runs already answer — stays cold.

        Checking the runs first means a restart does not re-spill the
        whole population through fresh run commits: the cold tier's own
        durable state seeds itself.  But first the persisted runs are
        reconciled against the authority: a cold key the BlobIndex no
        longer knows (GC / peer-loss prune since the runs committed)
        would misclassify a re-packed blob as duplicate, so any stale
        key invalidates the cold store wholesale — it is a cache, and
        the seeding below rebuilds it from the authority.
        """
        self.sharded = ShardedDedupIndex.create(
            self.n_shards, capacity=self.capacity, device=self.device)
        self._note_hbm()
        fill_cap = (self.n_shards * self.capacity) // 2
        seeded = 0
        hashes = self.host.known_hashes()
        if len(self.cold):
            known16 = {bytes(h[:16]) for h in hashes}
            cq = self.cold.known_queries()
            le = np.ascontiguousarray(cq.astype("<u4")).tobytes()
            if any(le[i * 16:(i + 1) * 16] not in known16
                   for i in range(len(cq))):
                self.cold.reset()
        for s in range(0, len(hashes), _SEED_BATCH):
            batch = hashes[s:s + _SEED_BATCH]
            q = hashes_to_queries(batch)
            if len(self.cold):
                fresh = np.flatnonzero(self.cold.classify(q) == 0)
                if fresh.size == 0:
                    continue
                q = q[fresh]
            take = min(len(q), max(0, fill_cap - seeded))
            if take:
                try:
                    self.sharded.insert(
                        q[:take], np.ones(take, dtype=np.uint32))
                    seeded += take
                except DedupIndexFull:
                    # probe clustering filled the table early: the whole
                    # segment goes cold (a key in both tiers is harmless)
                    self.cold.insert(q[:take])
                    fill_cap = seeded
            if take < len(q):
                self.cold.insert(q[take:])

    # --- growth / demotion ---------------------------------------------------

    def _grow(self) -> None:
        """Grow 4x while that fits the budget; at the cap, demote the
        cold half of the table instead of growing forever."""
        cap = self.capacity * 4
        while self.n_shards * cap * SLOT_BYTES <= self.hbm_budget_bytes:
            try:
                self.sharded = self.sharded.grown(cap)
                self.capacity = cap
                self._note_hbm()
                return
            except DedupIndexFull:
                cap *= 4
        self._demote()

    def _demote(self) -> None:
        """Spill the least-recently-probed keys to the cold store and
        rebuild the hot table with only the recent quarter.

        Ordering is make-before-break: the spill set is durable in the
        cold tier (run commit + fsync) before the old table is replaced,
        so a crash anywhere leaves every key classifiable — from the old
        hot table before, from the committed run after.
        """
        keys_q, vals = self.sharded.dump()
        # keep the recent quarter of the table (or half the residents
        # when pressure hit at low fill — pathological probe clustering):
        # post-demotion headroom must absorb a whole dispatch batch, and
        # a keep target of half the slots left zero room the moment a
        # demotion had just run.  The budget is a HARD cap: when even a
        # demoted table cannot take the batch, the bounded-retry parking
        # paths hand the keys to the cold tier instead of growing.
        keep_cap = min((self.n_shards * self.capacity) // 4,
                       len(keys_q) // 2)
        rank = {k: i for i, k in enumerate(self._recent)}
        # clock keys are the raw little-endian first-16-bytes (h[:16]),
        # exactly the u32 query words' LE serialization
        le = np.ascontiguousarray(keys_q.astype("<u4")).tobytes()
        order = np.fromiter(
            (rank.get(le[i * 16:(i + 1) * 16], -1)
             for i in range(len(keys_q))),
            dtype=np.int64, count=len(keys_q))
        keep_mask = np.zeros(len(keys_q), dtype=bool)
        if keep_cap:
            keep_mask[np.argsort(order, kind="stable")[-keep_cap:]] = True
        spill = ~keep_mask
        self.cold.insert(keys_q[spill], vals[spill])
        self.cold.flush()
        obs_profile.tier_demotions(int(spill.sum()))
        self.sharded = ShardedDedupIndex.create(
            self.n_shards, capacity=self.capacity, device=self.device)
        kq, kv = keys_q[keep_mask], vals[keep_mask]
        for s in range(0, len(kq), _SEED_BATCH):
            try:
                self.sharded.insert(kq[s:s + _SEED_BATCH],
                                    kv[s:s + _SEED_BATCH])
            except DedupIndexFull:  # pragma: no cover - keep set <= 1/4
                self.cold.insert(kq[s:], kv[s:])
                self.cold.flush()
                break
        self._note_hbm()

    # --- promotion clock -----------------------------------------------------

    def note_window(self, lanes: int, lost: int = 0) -> None:
        """Dispatch-site hook (ops/pipeline.py): one classify dispatch
        = one clock window.  ``lanes``/``lost`` describe the
        batch's real query lanes and exhausted-probe fallout."""
        self._saw_dispatch = True
        if lanes:
            self._tick_window()

    def _tick_window(self) -> None:
        self._windows += 1
        if self._windows % self.clock_windows == 0:
            self._run_clock()

    def _touch(self, key16: bytes) -> None:
        r = self._recent
        if key16 in r:
            r.move_to_end(key16)
        else:
            r[key16] = None
            cap = max(64, (self.n_shards * self.capacity) // 2)
            while len(r) > cap:
                r.popitem(last=False)

    def _note_cold_hit(self, key16: bytes) -> None:
        n = self._cold_hits.get(key16, 0) + 1
        self._cold_hits[key16] = n
        if n >= self.promote_min_hits:
            self._promote_queue[key16] = 1

    def _run_clock(self) -> None:
        """One promotion/demotion period: cold keys that crossed the hit
        threshold this period get re-pinned into HBM, then the counters
        reset so stale heat decays."""
        if self._promote_queue:
            keys = list(self._promote_queue)
            q = np.frombuffer(b"".join(keys), dtype="<u4").reshape(-1, 4)
            vals = np.ones(len(keys), dtype=np.uint32)
            for _ in range(2):
                try:
                    self.sharded.insert(q, vals)
                    for k in keys:
                        self._touch(k)
                    obs_profile.tier_promotions(len(keys))
                    break
                except DedupIndexFull:
                    self._grow()
            # still full after a demotion: skip this period's promotions
            # — the keys stay cold-classifiable, heat re-accrues
            self._promote_queue.clear()
        self._cold_hits.clear()

    # --- classify interface --------------------------------------------------

    def resolve_hints(self, hashes: List[bytes],
                      raw: List[Optional[bool]]) -> List[bool]:
        """Parent semantics plus the cold fall-through: concrete-False
        occurrences (device miss, the repurposed overflow-flag filter)
        consult the cold tier in one batch before being called new;
        ``None`` occurrences still go to the host authority."""
        hashes = [bytes(h) for h in hashes]
        if not hashes:
            return []
        _unset = object()
        facts: dict = {}
        for h, f in zip(hashes, raw):
            prev = facts.get(h, _unset)
            if prev is None:
                continue
            if f is None:
                facts[h] = None
            elif prev is _unset:
                facts[h] = bool(f)
            else:
                facts[h] = prev and bool(f)
        dev_probes = sum(1 for f in facts.values() if f is not None)
        dev_hits = sum(1 for f in facts.values() if f)
        obs_profile.tier_probes("device", dev_probes, dev_hits)
        miss = [h for h, f in facts.items() if f is False]
        if miss and self._pressure:
            ans = self.cold.classify(hashes_to_queries(miss))
            cold_hits = 0
            for h, a in zip(miss, ans):
                if a:
                    facts[h] = True
                    cold_hits += 1
                    self._note_cold_hit(h[:16])
            obs_profile.tier_probes("cold", len(miss), cold_hits)
        pend = [h for h, f in facts.items() if f is None]
        host_facts = {}
        if pend:
            for h in pend:
                host_facts[h] = self.host.is_duplicate(h)
            obs_profile.tier_probes("host", len(pend),
                                    sum(host_facts.values()))
            q = hashes_to_queries(pend)
            vals = np.ones(len(pend), dtype=np.uint32)
            attempts = 0
            while True:
                try:
                    self.sharded.insert(q, vals)
                    break
                except DedupIndexFull:
                    attempts += 1
                    if attempts >= 3:
                        # batch ~ table size at the budget cap: park the
                        # keys in the cold tier instead of thrashing the
                        # demotion path — still classifiable everywhere
                        self.cold.insert(q)
                        break
                    self._grow()
        if self._pressure:
            for h in facts:
                self._touch(h[:16])
        if not self._saw_dispatch:
            self._tick_window()
        flags: List[bool] = []
        seen: set = set()
        for h in hashes:
            if h in seen:
                flags.append(True)
            else:
                seen.add(h)
                f = facts[h]
                flags.append(host_facts[h] if f is None else f)
        return flags

    def classify_insert(self, hashes: List[bytes]) -> List[bool]:
        """Parent semantics plus the cold fall-through for device-new
        verdicts (and budget-capped growth via the overridden _grow)."""
        hashes = [bytes(h) for h in hashes]
        if not hashes:
            return []
        first: dict = {}
        uniq: List[bytes] = []
        for h in hashes:
            if h not in first:
                first[h] = len(uniq)
                uniq.append(h)
        q = hashes_to_queries(uniq)
        vals = np.ones(len(uniq), dtype=np.uint32)
        interrupted = False
        attempts = 0
        found = None
        while True:
            try:
                found = self.sharded.insert(q, vals)
                break
            except DedupIndexFull:
                # a demotion/growth mid-batch may have scattered part of
                # the batch; verdicts resolve against the host authority
                interrupted = True
                attempts += 1
                if attempts >= 3:
                    # batch ~ table size at the budget cap: park the keys
                    # cold and let the authority answer this batch
                    self.cold.insert(q)
                    break
                self._grow()
        cold_dup: set = set()
        if interrupted:
            obs_profile.tier_probes("host", len(uniq))
        else:
            miss_idx = np.flatnonzero(found == 0)
            obs_profile.tier_probes("device", len(uniq),
                                    len(uniq) - miss_idx.size)
            if miss_idx.size and self._pressure:
                ans = self.cold.classify(q[miss_idx])
                cold_hits = 0
                for i, a in zip(miss_idx.tolist(), ans.tolist()):
                    if a:
                        cold_dup.add(uniq[i])
                        cold_hits += 1
                        self._note_cold_hit(uniq[i][:16])
                obs_profile.tier_probes("cold", int(miss_idx.size),
                                        cold_hits)
        if self._pressure:
            for h in uniq:
                self._touch(h[:16])
        self._tick_window()
        flags: List[bool] = []
        seen: set = set()
        for h in hashes:
            if h in seen:
                flags.append(True)
            elif interrupted:
                seen.add(h)
                flags.append(self.host.is_duplicate(h))
            else:
                seen.add(h)
                flags.append(bool(found[first[h]] > 0) or h in cold_dup)
        return flags
