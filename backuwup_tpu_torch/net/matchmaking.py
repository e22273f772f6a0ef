"""Sharded in-memory matchmaking (the PR-10 scale-out of StorageQueue).

Counterpart of ``backuwup_tpu/net/matchmaking.py``, copied so that the
port imports nothing of the JAX package.

The original ``StorageQueue`` serializes the whole economy behind ONE
``asyncio.Lock`` held across the entire fulfill — including the
negotiation db writes and both WebSocket pushes — and expires entries by
rescanning a python list.  :class:`ShardedMatchmaker` keeps the exact
matchmaking semantics (see below) but restructures the state for
contention:

* **N pubkey-keyed shards** — a queued request lives in its owner's home
  shard (``shard = int.from_bytes(pubkey[:8]) % N``).  Each shard has
  its own lock, FIFO deque, and entry table.
* **per-shard locks, never held across an await** — a lock guards only
  the O(1)/O(log n) pops and pushes; the db writes and client pushes of
  a match run lock-free, so concurrent fulfills from different clients
  overlap their I/O instead of queueing behind one critical section.
* **O(log n) expiry via deadline heaps** — each shard keeps a
  ``(expires_at, seq)`` min-heap beside the FIFO; reaping pops only
  expired heads (heap pops, no rescans).  ``reap_ops`` counts heap
  operations so the test can assert the bound.
* **cross-shard work stealing** — fulfill starts at the requester's home
  shard and walks the ring, so a deep queue on one shard still fulfills
  requesters homed anywhere.

Preserved semantics (tests/test_control_plane.py, test_audit.py,
test_erasure.py pin these on the legacy queue; the sharded tests mirror
them):

* FIFO within a shard; expired and offline entries are dropped at pop;
* a popped self-match is discarded, not re-enqueued;
* candidates audit-blocked by ≥ ``AUDIT_SERVER_BLOCK_FAILURES`` distinct
  failing reporters are dropped;
* the negotiation is recorded FIRST, then pushed: a candidate-push
  failure rolls both records back and drops the candidate; a
  requester-push failure keeps the records, re-enqueues the candidate's
  remainder, and stops matching for the dead requester;
* ``min_peers > 1`` caps each match at an even share while enough
  distinct other clients are queued to plausibly reach the spread.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
from collections import deque
from typing import Dict, List, Optional, Tuple

from .. import defaults, wire
from ..obs import metrics as obs_metrics
from ..utils import clock as clockmod

_QUEUE_DEPTH = obs_metrics.gauge(
    "bkw_matchmaking_queue_depth",
    "Storage requests waiting in the matchmaking queue")
_MATCHMAKINGS = obs_metrics.counter(
    "bkw_matchmakings_total",
    "Matchmaking pairings recorded (negotiation persisted, candidate"
    " notified)")
_EXPIRED = obs_metrics.counter(
    "bkw_matchmaking_expired_total",
    "Queued storage requests dropped by deadline-heap expiry")


class _Shard:
    """One matchmaking shard: FIFO + deadline heap over an entry table.

    ``entries`` maps a monotonically increasing ``seq`` to a live
    ``[client_id, remaining, expires_at]`` record; the FIFO and the heap
    hold seqs (possibly stale — a seq missing from ``entries`` was
    consumed or reaped and is skipped at pop, each skip O(1)).
    """

    def __init__(self, index: int):
        self.index = index
        self.lock = asyncio.Lock()
        self.entries: Dict[int, list] = {}
        self.fifo: deque = deque()
        self.heap: List[Tuple[float, int]] = []
        self.reap_ops = 0  # deadline-heap pops (the O(log n) evidence)

    def add(self, seq: int, client: bytes, remaining: int,
            expires_at: float) -> None:
        self.entries[seq] = [client, remaining, expires_at]
        self.fifo.append(seq)
        heapq.heappush(self.heap, (expires_at, seq))

    def reap(self, now: float) -> int:
        """Drop every expired entry by popping the deadline heap — no
        scan of live entries.  Returns the number dropped."""
        dropped = 0
        while self.heap and self.heap[0][0] < now:
            _expires, seq = heapq.heappop(self.heap)
            self.reap_ops += 1
            if seq in self.entries:
                del self.entries[seq]
                dropped += 1
        if dropped:
            _EXPIRED.inc(dropped)
        return dropped

    def pop(self, now: float, connections) -> Optional[list]:
        """Oldest live entry whose client is online; offline entries are
        dropped (legacy ``_pop_valid`` semantics)."""
        self.reap(now)
        while self.fifo:
            seq = self.fifo.popleft()
            entry = self.entries.pop(seq, None)
            if entry is None:
                continue  # stale seq: consumed or reaped
            if connections.is_online(entry[0]):
                return entry
        return None

    def depth(self) -> int:
        return len(self.entries)


class ShardedMatchmaker:
    """Drop-in for ``StorageQueue`` in the stateless request tier; the
    durable negotiation writes go through ``store.aio`` so the event
    loop never waits on a commit it didn't have to."""

    def __init__(self, store, connections,
                 expiry_s: Optional[float] = None,
                 shards: Optional[int] = None,
                 clock=None):
        self.db = store
        self.connections = connections
        self.clock = clockmod.resolve(clock)
        self.expiry_s = (defaults.BACKUP_REQUEST_EXPIRY_S
                         if expiry_s is None else expiry_s)
        n = defaults.MATCHMAKING_SHARDS if not shards else int(shards)
        self.shards = [_Shard(i) for i in range(max(n, 1))]
        self._seq = itertools.count(1)
        #: Federation hook (docs/server.md §Federation): an async
        #: ``(requester, want, share_cap) -> Optional[(candidate, match)]``
        #: consulted only after every LOCAL shard came up empty — the
        #: remote continuation of the home-shard-last steal walk.  The
        #: serving node records the negotiation (both edges) and pushes
        #: to the candidate before answering, so by the time this
        #: returns, only the requester-side push remains.  None = no
        #: federation (single-node deployments) or no remote candidate.
        self.remote_steal = None

    # --- shard routing ------------------------------------------------------

    def shard_of(self, client_id: bytes) -> _Shard:
        key = int.from_bytes(bytes(client_id)[:8] or b"\0", "big")
        return self.shards[key % len(self.shards)]

    def _enqueue(self, client_id: bytes, remaining: int,
                 expires_at: float) -> None:
        self.shard_of(client_id).add(next(self._seq), bytes(client_id),
                                     remaining, expires_at)

    def _distinct_others(self, client_id: bytes) -> int:
        me = bytes(client_id)
        return len({e[0] for s in self.shards for e in s.entries.values()
                    if e[0] != me})

    async def _pop_candidate(self, requester: bytes) -> Optional[list]:
        """Steal work around the ring starting at the shard AFTER the
        requester's home and visiting home last: the requester's own
        queued remainders live in its home shard, and popping them first
        would discard them as self-matches far more often than the
        legacy global FIFO ever did (measured: it halves the match rate
        under uniform load).  The shard lock covers only the pop
        itself."""
        now = self.clock.now()
        home = self.shard_of(requester).index
        n = len(self.shards)
        for i in range(1, n + 1):
            shard = self.shards[(home + i) % n]
            async with shard.lock:
                while True:
                    entry = shard.pop(now, self.connections)
                    if entry is None:
                        break
                    if entry[0] == bytes(requester):
                        continue  # self-match discarded
                    return entry
        return None

    # --- the economy --------------------------------------------------------

    async def fulfill(self, client_id: bytes, storage_required: int,
                      min_peers: int = 1) -> None:
        """Match against queued requests; both sides get BackupMatched
        for min(remaining, candidate); remainders re-enqueue.  Semantics
        mirror ``StorageQueue.fulfill`` (see the module docstring); the
        structural difference is that no lock is held across the store
        writes or the pushes, so fulfills for different clients overlap.

        Two concurrent fulfills can no longer observe each other's
        half-made matches through a shared critical section — but they
        never could observe anything useful there either: every pop
        removes the entry before any await, so each queued request still
        has exactly one consumer.
        """
        if storage_required > defaults.MAX_BACKUP_STORAGE_REQUEST_SIZE:
            raise ValueError("storage request exceeds protocol cap")
        me = bytes(client_id)
        min_peers = max(int(min_peers), 1)
        share_cap = None
        if min_peers > 1 and self._distinct_others(me) >= min_peers:
            share_cap = -(-storage_required // min_peers)
        remaining = storage_required
        while remaining > 0:
            entry = await self._pop_candidate(me)
            if entry is None:
                # Every local shard is empty: go remote (federation's
                # continuation of the home-last walk).  The serving node
                # has already recorded the negotiation and notified the
                # candidate, so only the requester-side push remains —
                # and a failed requester push keeps the records and
                # stops, exactly the legacy requester-dead semantics.
                if self.remote_steal is None:
                    break
                stolen = await self.remote_steal(me, remaining, share_cap)
                if stolen is None:
                    break
                r_candidate, r_match = stolen
                ok_self = await self.connections.notify(
                    me, wire.BackupMatched(destination_id=r_candidate,
                                           storage_available=r_match))
                if not ok_self:
                    self._refresh_depth()
                    return
                remaining -= r_match
                continue
            candidate, cand_remaining, cand_expires = entry
            if await self.db.aio.audit_failing_reporters(
                    candidate, defaults.AUDIT_REPORT_WINDOW_S) \
                    >= defaults.AUDIT_SERVER_BLOCK_FAILURES:
                # independently reported as failing storage audits: drop
                # its queued request rather than hand it new data
                continue
            match = min(remaining, cand_remaining)
            if share_cap is not None:
                match = min(match, share_cap)
            # Record FIRST, then push (the legacy invariant): a client
            # must never learn of a match the server does not persist.
            # The awaits resolve only after the write-behind group
            # commit, so the durability barrier holds per match.
            await self.db.aio.save_storage_negotiated(me, candidate, match)
            await self.db.aio.save_storage_negotiated(candidate, me, match)
            ok_cand = await self.connections.notify(
                candidate, wire.BackupMatched(
                    destination_id=me, storage_available=match))
            if not ok_cand:
                # candidate unreachable: roll back, drop its queued
                # request, and try the next one
                await self.db.aio.delete_storage_negotiated(
                    me, candidate, match)
                await self.db.aio.delete_storage_negotiated(
                    candidate, me, match)
                continue
            _MATCHMAKINGS.inc()
            ok_self = await self.connections.notify(
                me, wire.BackupMatched(
                    destination_id=candidate, storage_available=match))
            if not ok_self:
                # the requester is unreachable but the candidate has
                # already been told: keep the record, re-enqueue the
                # candidate's remainder, stop matching for the dead
                # requester
                cand_remaining -= match
                if cand_remaining > 0:
                    shard = self.shard_of(candidate)
                    async with shard.lock:
                        shard.add(next(self._seq), candidate,
                                  cand_remaining, cand_expires)
                self._refresh_depth()
                return
            remaining -= match
            cand_remaining -= match
            if cand_remaining > 0:
                shard = self.shard_of(candidate)
                async with shard.lock:
                    shard.add(next(self._seq), candidate, cand_remaining,
                              cand_expires)
        if remaining > 0:
            shard = self.shard_of(me)
            async with shard.lock:
                shard.add(next(self._seq), me, remaining,
                          self.clock.now() + self.expiry_s)
        self._refresh_depth()

    async def serve_steal(self, requester: bytes, want: int,
                          share_cap: Optional[int] = None
                          ) -> Optional[Tuple[bytes, int]]:
        """Serve one cross-node steal (the /fed/steal RPC body): pop a
        local candidate for a REMOTE requester, record the negotiation,
        and push to the (locally connected) candidate.

        This is one iteration of :meth:`fulfill` with the requester-side
        push left to the requester's own node — the candidate-side
        invariants are identical: audit-blocked candidates dropped,
        record-first-then-push, a failed candidate push rolls both edges
        back and tries the next candidate, remainders re-enqueue, and
        ``_MATCHMAKINGS`` counts here (the serving side) only, so a
        pairing is counted exactly once across the federation.

        Returns ``(candidate_pubkey, matched_bytes)`` or None when no
        eligible local candidate exists.
        """
        me = bytes(requester)
        want = int(want)
        while True:
            entry = await self._pop_candidate(me)
            if entry is None:
                return None
            candidate, cand_remaining, cand_expires = entry
            if await self.db.aio.audit_failing_reporters(
                    candidate, defaults.AUDIT_REPORT_WINDOW_S) \
                    >= defaults.AUDIT_SERVER_BLOCK_FAILURES:
                continue
            match = min(want, cand_remaining)
            if share_cap is not None:
                match = min(match, int(share_cap))
            # Both edges recorded by the serving node (the store routes
            # each by pubkey, so placement is identical to a local
            # fulfill) — keeping record-then-push atomic on one node
            # instead of splitting the rollback across the RPC.
            await self.db.aio.save_storage_negotiated(me, candidate, match)
            await self.db.aio.save_storage_negotiated(candidate, me, match)
            ok_cand = await self.connections.notify(
                candidate, wire.BackupMatched(
                    destination_id=me, storage_available=match))
            if not ok_cand:
                await self.db.aio.delete_storage_negotiated(
                    me, candidate, match)
                await self.db.aio.delete_storage_negotiated(
                    candidate, me, match)
                continue
            _MATCHMAKINGS.inc()
            cand_remaining -= match
            if cand_remaining > 0:
                shard = self.shard_of(candidate)
                async with shard.lock:
                    shard.add(next(self._seq), candidate, cand_remaining,
                              cand_expires)
            self._refresh_depth()
            return candidate, match

    # --- introspection ------------------------------------------------------

    def _refresh_depth(self) -> int:
        depth = sum(s.depth() for s in self.shards)
        _QUEUE_DEPTH.set(depth)
        return depth

    def pending(self) -> int:
        """Live queued requests (expired entries reaped first).  Safe to
        call from sync code: every lock-guarded critical section in this
        class is await-free, so no coroutine can be mid-mutation while
        sync code runs on the loop."""
        now = self.clock.now()
        for shard in self.shards:
            shard.reap(now)
        return self._refresh_depth()

    def reap_ops(self) -> int:
        """Total deadline-heap pops across shards (test instrumentation
        for the O(log n) expiry bound)."""
        return sum(s.reap_ops for s in self.shards)
