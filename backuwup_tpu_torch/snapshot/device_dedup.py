"""Device dedup front: batched classify on the sharded device table.

Counterpart of ``backuwup_tpu/snapshot/device_dedup.py``.  The reference
answers "have I stored this blob?" one binary search at a time on the host
(``blob_index.rs:130-148``); here a whole batch of fingerprints is asked in
one device call against :class:`~..ops.dedup_index.ShardedDedupIndex`.

:class:`MeshDedupIndex` (the name is kept so a reader finds the
counterpart; there is no mesh: the shards live on one device) is the
bridge to the host authority:

* the dedup *decision* for every chunk batch comes from the device table;
* the host authority stays the persisted truth and the parity oracle;
* table pressure (:class:`~..ops.dedup_index.DedupIndexFull`) grows the
  table 4x with an on-device migration, so the device table is a cache
  that can always be rebuilt from the host.

**Host authority contract.**  ``host_index`` is any object with:

* ``len(host_index)`` -- committed hashes;
* ``host_index.queued_count`` -- hashes queued but not yet committed;
* ``host_index.known_hashes()`` -- every hash ``is_duplicate`` answers
  True for (the seed set of the device table);
* ``host_index.is_duplicate(h) -> bool`` for a 32-byte digest.

The JAX package's ``BlobIndex`` satisfies it; a set-backed object of a
few lines does too.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional

import numpy as np
import torch

from .. import defaults
from ..ops.dedup_index import (
    DedupIndexFull,
    ShardedDedupIndex,
    hashes_to_queries,
)
from ..utils.device import resolve_device

_SEED_BATCH = 8192


class MeshDedupIndex:
    """Batched membership classify+insert on one device."""

    def __init__(self, host_index, n_shards: int = 1,
                 capacity: Optional[int] = None, device=None):
        self.host = host_index
        self.n_shards = n_shards
        self.device = resolve_device(device)
        known = len(host_index) + host_index.queued_count
        need = max(defaults.DEDUP_SHARD_CAPACITY,
                   _next_pow2(4 * max(known, 1) // max(n_shards, 1)))
        self.capacity = capacity or need
        # all-ones value vectors for classify_dispatch, keyed by lane count
        self._ones_cache: OrderedDict = OrderedDict()
        self._rebuild()

    def _rebuild(self) -> None:
        self.sharded = ShardedDedupIndex.create(
            self.n_shards, capacity=self.capacity, device=self.device)
        hashes = self.host.known_hashes()
        for s in range(0, len(hashes), _SEED_BATCH):
            batch = hashes[s:s + _SEED_BATCH]
            self.sharded.insert(hashes_to_queries(batch),
                                np.ones(len(batch), dtype=np.uint32))

    def _grow(self) -> None:
        # 4x jump + on-device migration; a failed grown() leaves the old
        # table intact, so keep growing until the migration fits
        cap = self.capacity * 4
        while True:
            try:
                self.sharded = self.sharded.grown(cap)
                break
            except DedupIndexFull:
                cap *= 4
        self.capacity = cap

    def classify_dispatch(self, q_dev: torch.Tensor):
        """Device-resident classify+insert of a ``(..., 4)`` int32 query
        slab (``queries_from_cvs`` of a digest accumulator: the
        fingerprints never visit the host).  New keys insert with value 1;
        returns the ``(found, lost)`` device tensors WITHOUT any host
        synchronization: ``found != 0`` means the key was resident BEFORE
        this batch's insert; nonzero ``lost`` lanes must be resolved
        against the host authority (:meth:`resolve_hints` does both)."""
        n = int(np.prod(q_dev.shape[:-1]))
        return self.sharded.insert_device(q_dev, self._ones(n))

    def _ones(self, n: int) -> torch.Tensor:
        v = self._ones_cache.get(n)
        if v is None:
            while len(self._ones_cache) >= 64:
                self._ones_cache.popitem(last=False)
            v = self._ones_cache[n] = torch.ones(n, dtype=torch.int32,
                                                 device=self.device)
        else:
            self._ones_cache.move_to_end(n)
        return v

    def resolve_hints(self, hashes: List[bytes],
                      raw: List[Optional[bool]]) -> List[bool]:
        """Merge per-occurrence device found-flags into final dup hints.

        ``raw[i]`` is occurrence i's flag from :meth:`classify_dispatch`
        (truthy = resident before its insert batch) or ``None`` when the
        device path could not classify it (candidate or pool overflow,
        lost lane, tiny/long/empty stream).  Occurrences of one hash in
        one insert batch all report the pre-batch state and a later batch
        sees an earlier one's insert, so ANDing the concrete flags gives
        "resident before the call", and the walk below restores
        first-occurrence-new / repeat-duplicate.  A ``None`` occurrence
        poisons its hash: the host authority answers, and the hash is
        re-inserted so the device table stays a superset of the batch.
        """
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
        pend = [h for h, f in facts.items() if f is None]
        host_facts = {}
        if pend:
            for h in pend:
                host_facts[h] = self.host.is_duplicate(h)
            q = hashes_to_queries(pend)
            vals = np.ones(len(pend), dtype=np.uint32)
            while True:
                try:
                    self.sharded.insert(q, vals)
                    break
                except DedupIndexFull:
                    self._grow()
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
        """is-duplicate flag per hash; new hashes become table-resident.
        Intra-batch repeats are resolved here (first occurrence "new",
        the rest "duplicate")."""
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
        while True:
            try:
                found = self.sharded.insert(q, vals)
                break
            except DedupIndexFull:
                # the failed attempt may have placed part of the batch;
                # after the migration a retry would see those keys as
                # resident, so the host authority (prior batches only)
                # answers for this batch
                self._grow()
                interrupted = True
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
                flags.append(bool(found[first[h]] > 0))
        return flags


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p
