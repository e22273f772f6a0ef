"""Sharded dedup-index probe: the blob-hash table on one device.

Counterpart of ``backuwup_tpu/ops/dedup_index.py``.  The table is an
open-addressed hash table of 128-bit keys (the first 16 bytes of a BLAKE3
digest as four u32 words; all-zero = empty) and u32 values, split into
``D`` shards.  The shards live on ONE device as a ``(D, capacity, 4)``
int32 key tensor and a ``(D, capacity)`` value tensor (u32 bits): a
query's shard is ``q[0] % D`` and its first slot ``q[1] % capacity``
(both unsigned), as in the JAX program.  On the card ``D = 1``; ``D > 1``
lets the tests hold layouts against the JAX table on a multi-device mesh.

Same contracts: ``found = value + 1`` (u32, wrapping) or 0; insert rounds
report ``lost`` = ``LOST_RACE`` (1) for a lane that still lost a slot
race after the retry rounds and ``LOST_EXHAUSTED`` (2) for a probe
sequence that found neither the key nor an empty slot.  An insert is one
round against the table as it stood at the start of the round, then up
to ``_RETRY_ROUNDS`` rounds for the lanes that lost a race; a new key
claims its slot with the highest query index winning (XLA's scatter lets
the last update win), for keys and values alike, so tables match the JAX
table bit for bit.

The device work is ``csrc/dedup_probe.cu`` (K5; it replaces an XLA
program of the JAX package, not a Pallas kernel), through three wrappers:
:func:`probe_table`, :func:`insert_table` and :func:`migrate_round` (a
growth's every round, one launch).  On a CUDA tensor each launches its
kernel or raises; on a CPU tensor it runs its plain version.  The tables
are updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import defaults
from ..utils.device import resolve_device
from .u32 import M32, from_bits, to_bits

KEY_WORDS = 4  # 128-bit stored fingerprint of the 256-bit blake3 hash

# `lost` codes of an insert:
LOST_RACE = 1  # lost an intra-batch empty-slot race: retryable
LOST_EXHAUSTED = 2  # probe sequence exhausted (shard full): not retryable

# rounds after the first in which the lanes that lost a race retry; the
# JAX program's on-device retry cap
_RETRY_ROUNDS = 10


class DedupIndexFull(RuntimeError):
    """A shard's probe sequence was exhausted; the table needs resizing."""


def hashes_to_queries(hashes) -> np.ndarray:
    """List of 32-byte digests -> (N, 4) u32 query words (first 16 bytes)."""
    if len(hashes) == 0:
        return np.zeros((0, KEY_WORDS), dtype=np.uint32)
    buf = np.frombuffer(b"".join(bytes(h)[:16] for h in hashes),
                        dtype="<u4").reshape(-1, KEY_WORDS)
    return np.ascontiguousarray(buf)


def queries_from_cvs(acc: torch.Tensor) -> torch.Tensor:
    """Device-resident analog of :func:`hashes_to_queries`: the first four
    words of each ``(N, 8)`` root chaining value ARE the first 16 digest
    bytes.  Unplaced accumulator rows are all-zero
    (``digest_pool.pool_digest`` scatters placed chunks into zeros), which
    is the table's padding convention, so the whole slab feeds
    :meth:`ShardedDedupIndex.insert_device` unmasked."""
    return acc[:, :KEY_WORDS]


# --- plain versions ----------------------------------------------------------


def _table_geometry(keys: torch.Tensor):
    D, cap = int(keys.shape[0]), int(keys.shape[1])
    return D, cap, keys.view(D * cap, KEY_WORDS)


def _route(q: torch.Tensor, D: int, cap: int):
    """(shard base, first local slot) per query, unsigned, int64."""
    return (from_bits(q[:, 0]) % D) * cap, from_bits(q[:, 1]) % cap


def _walk_plain(k2, v1, q, base, start, cap: int, max_probes: int,
                probing: torch.Tensor, match: bool = True):
    """Linear probe of every ``probing`` query: ``(found, slot, done)``
    with ``slot`` the local index of the first slot holding the key (when
    ``match``) or empty, -1 if none within ``max_probes`` steps.  Each
    step reads only the lanes still walking."""
    done = ~probing
    found = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    slot = torch.full_like(found, -1)
    live = torch.nonzero(probing).reshape(-1)
    for p in range(max_probes):
        if live.numel() == 0:
            break  # every later step is a no-op
        idx = (start[live] + p) % cap
        g = base[live] + idx
        k = k2[g]
        term = (k == 0).all(dim=1)
        if match:
            hit = (k == q[live]).all(dim=1)
            term = hit | term
            found[live[hit]] = (from_bits(v1[g[hit]]) + 1) & M32
        ended = live[term]
        slot[ended] = idx[term]
        done[ended] = True
        live = live[~term]
    return found, slot, done


def _claim_plain(targets: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Per target, whether its lane (index) is the highest claiming the
    slot; ``targets`` == ``n_slots`` claims nothing."""
    lane = torch.arange(targets.shape[0], dtype=torch.int64,
                        device=targets.device)
    claim = torch.full((n_slots + 1,), -1, dtype=torch.int64,
                       device=targets.device)
    claim.scatter_reduce_(0, targets, lane, reduce="amax")
    return (claim[targets] == lane) & (targets < n_slots)


def probe_table_plain(keys: torch.Tensor, values: torch.Tensor,
                      q: torch.Tensor, *, max_probes: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`probe_table`."""
    D, cap, k2 = _table_geometry(keys)
    base, start = _route(q, D, cap)
    probing = ~(q == 0).all(dim=1)  # all-zero rows are padding
    found, _slot, _done = _walk_plain(k2, values.reshape(-1), q, base, start,
                                      cap, max_probes, probing)
    return to_bits(found)


def insert_table_plain(keys: torch.Tensor, values: torch.Tensor,
                       q: torch.Tensor, v: torch.Tensor, *, max_probes: int):
    """Plain PyTorch version of :func:`insert_table` (same rounds, the
    claim by ``scatter_reduce(amax)``); updates the tables in place."""
    D, cap, k2 = _table_geometry(keys)
    v1 = values.view(-1)
    base, start = _route(q, D, cap)
    real = ~(q == 0).all(dim=1)
    active = torch.ones_like(real)
    exh = torch.zeros_like(real)
    found = None
    for r in range(1 + _RETRY_ROUNDS):
        f, slot, done = _walk_plain(k2, v1, q, base, start, cap, max_probes,
                                    active & real)
        if r == 0:
            found = f
        is_new = active & real & (f == 0) & (slot >= 0)
        g = base + slot.clamp(min=0)
        win = is_new & _claim_plain(torch.where(is_new, g, D * cap), D * cap)
        k2[g[win]] = q[win]
        v1[g[win]] = v[win]
        race = is_new & ~(k2[g] == q).all(dim=1)
        exh = exh | (active & ~done)
        active = race
        if not bool(active.any()):
            break  # a round with no racing lane changes nothing
    lost = active.to(torch.int32) * LOST_RACE + exh.to(torch.int32) \
        * LOST_EXHAUSTED
    return to_bits(found), lost


def migrate_round_plain(old_keys: torch.Tensor, old_values: torch.Tensor,
                        new_keys: torch.Tensor, new_values: torch.Tensor,
                        pending: torch.Tensor, *, max_probes: int):
    """One rehash round of the pending (``pending`` (D*old_capacity,) u8,
    updated in place) resident keys into the larger table; returns
    ``(any still pending, exhausted)``.  One round only: the plain twin
    of the card's whole migration, :func:`migrate_round`, is
    :func:`migrate_plain`, which loops over this."""
    D, oc, ok = _table_geometry(old_keys)
    _D, nc, nk = _table_geometry(new_keys)
    nv = new_values.view(-1)
    j = torch.arange(D * oc, dtype=torch.int64, device=ok.device)
    base = (j // oc) * nc
    pend = pending.bool()
    _f, slot, done = _walk_plain(nk, nv, ok, base, from_bits(ok[:, 1]) % nc,
                                 nc, max_probes, pend, match=False)
    can = pend & (slot >= 0)
    exhausted = bool((pend & ~done).any())
    g = base + slot.clamp(min=0)
    win = can & _claim_plain(torch.where(can, g, D * nc), D * nc)
    nk[g[win]] = ok[win]
    nv[g[win]] = old_values.reshape(-1)[win]
    won = can & (nk[g] == ok).all(dim=1)
    pending.copy_((pend & ~won).to(torch.uint8))
    return bool(pending.any()), exhausted


def migrate_plain(old_keys: torch.Tensor, old_values: torch.Tensor,
                  new_keys: torch.Tensor, new_values: torch.Tensor, *,
                  max_probes: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`migrate_round`: rounds of
    :func:`migrate_round_plain` over every resident key until nothing is
    pending or a walk is exhausted."""
    pending = (old_keys != 0).any(dim=2).reshape(-1).to(torch.uint8)
    rounds = 0
    while True:
        more, exhausted = migrate_round_plain(
            old_keys, old_values, new_keys, new_values, pending,
            max_probes=max_probes)
        rounds += 1
        if exhausted or not more:
            return torch.tensor([rounds, int(exhausted)], dtype=torch.int32,
                                device=old_keys.device)


# --- kernel wrappers ---------------------------------------------------------


def _check_table(keys: torch.Tensor, values: torch.Tensor) -> None:
    if keys.dtype != torch.int32 or keys.dim() != 3 \
            or keys.shape[2] != KEY_WORDS:
        raise TypeError("keys must be a (D, capacity, 4) int32 tensor")
    if values.dtype != torch.int32 or values.shape != keys.shape[:2]:
        raise TypeError("values must be a (D, capacity) int32 tensor")
    if not (keys.is_contiguous() and values.is_contiguous()):
        raise ValueError("the table tensors must be contiguous")
    if keys.shape[0] * keys.shape[1] >= 1 << 31:
        raise ValueError("table exceeds 2^31 slots")


def _check_queries(keys: torch.Tensor, q: torch.Tensor) -> None:
    if q.dtype != torch.int32 or q.dim() != 2 or q.shape[1] != KEY_WORDS:
        raise TypeError("queries must be an (N, 4) int32 tensor")
    if q.device != keys.device:
        raise ValueError("queries and table must be on one device")
    if q.shape[0] >= 1 << 31:
        raise ValueError("too many queries in one batch")


def _on_card(keys: torch.Tensor) -> bool:
    if keys.device.type == "cpu":
        return False
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    _check_aligned(keys, "keys")
    return True


def _check_aligned(t: torch.Tensor, what: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned for the kernel")


def probe_table(keys: torch.Tensor, values: torch.Tensor, q: torch.Tensor,
                *, max_probes: int) -> torch.Tensor:
    """``found`` (N,) int32 (u32 bits) of (N, 4) queries against the
    table; read only."""
    _check_table(keys, values)
    _check_queries(keys, q)
    if not _on_card(keys):
        return probe_table_plain(keys, values, q, max_probes=max_probes)
    from .. import kernels

    q = q.contiguous()
    found = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    if q.shape[0] == 0:
        return found
    _check_aligned(q, "queries")  # the kernel loads a row as one uint4
    lib = kernels.library("dedup_probe")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bkw_dedup_probe(
            keys.data_ptr(), values.data_ptr(), q.data_ptr(), q.shape[0],
            keys.shape[0], keys.shape[1], max_probes, found.data_ptr(),
            stream)
    kernels.check_launch(rc, "dedup_probe")
    probe_table.launches += 1
    return found


class InsertScratch:
    """The insert kernel's scratch on the card, kept between calls the way
    the claim vector is: per lane ``state`` (u8) and ``gslot`` (i64),
    grown to the largest batch, and ``races`` (i32), the lanes still
    racing after each round of the last launch (the kernel zeroes it, so
    making or reusing a scratch launches nothing)."""

    def __init__(self, device: torch.device):
        self.state = torch.empty(0, dtype=torch.uint8, device=device)
        self.gslot = torch.empty(0, dtype=torch.int64, device=device)
        self.races = torch.empty(1 + _RETRY_ROUNDS, dtype=torch.int32,
                                 device=device)

    def reserve(self, n: int) -> None:
        if self.state.shape[0] < n:
            self.state = torch.empty(n, dtype=torch.uint8,
                                     device=self.state.device)
            self.gslot = torch.empty(n, dtype=torch.int64,
                                     device=self.state.device)

    def rounds_run(self) -> int:
        """Rounds the last insert launch ran (reading it syncs the host):
        round r + 1 runs only when lanes still raced after round r."""
        counts = self.races.tolist()
        return 1 + sum(1 for c in counts[:-1] if c > 0)


def insert_table(keys: torch.Tensor, values: torch.Tensor, q: torch.Tensor,
                 v: torch.Tensor, *, max_probes: int,
                 claim: Optional[torch.Tensor] = None,
                 scratch: Optional[InsertScratch] = None):
    """Insert (N, 4) queries with (N,) values in place; returns ``(found,
    lost)`` (N,) int32, ``found`` from the first round (the pre-batch
    state).  On the card ``claim`` is the table's (D*capacity,) int32
    claim vector, all -1 (the kernel leaves it so), and ``scratch`` the
    table's :class:`InsertScratch`; the call is one kernel launch."""
    _check_table(keys, values)
    _check_queries(keys, q)
    if v.dtype != torch.int32 or v.shape != q.shape[:1] \
            or v.device != q.device:
        raise TypeError("values must be an (N,) int32 tensor beside q")
    if not _on_card(keys):
        return insert_table_plain(keys, values, q, v, max_probes=max_probes)
    from .. import kernels

    n = q.shape[0]
    if claim is None or claim.dtype != torch.int32 \
            or claim.shape != (keys.shape[0] * keys.shape[1],) \
            or claim.device != keys.device:
        raise ValueError("the kernel needs the table's int32 claim vector")
    if scratch is None or scratch.races.device != keys.device:
        raise ValueError("the kernel needs the table's insert scratch")
    q, v = q.contiguous(), v.contiguous()
    found = torch.empty(n, dtype=torch.int32, device=q.device)
    lost = torch.empty_like(found)
    if n == 0:
        return found, lost
    scratch.reserve(n)
    lib = kernels.library("dedup_probe")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bkw_dedup_insert(
            keys.data_ptr(), values.data_ptr(), q.data_ptr(), v.data_ptr(), n,
            keys.shape[0], keys.shape[1], max_probes, 1 + _RETRY_ROUNDS,
            found.data_ptr(), lost.data_ptr(), scratch.state.data_ptr(),
            scratch.gslot.data_ptr(), claim.data_ptr(),
            scratch.races.data_ptr(), stream)
    kernels.check_launch(rc, "dedup_probe")
    insert_table.launches += 1
    return found, lost


def migrate_round(old_keys: torch.Tensor, old_values: torch.Tensor,
                  new_keys: torch.Tensor, new_values: torch.Tensor, *,
                  max_probes: int,
                  claim: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rehash every resident key of the old table into the larger, empty
    new one (updated in place), round after round until nothing is pending
    or a walk is exhausted; returns ``(rounds run, exhausted)`` as a (2,)
    int32 tensor beside the tables, without a host sync (reading it is
    the growth's one host read).  On the card ``claim`` is the new
    table's (D*new_capacity,) int32 claim vector, all -1 (the kernel
    leaves it so), and the whole migration is one kernel launch.  Despite
    the name this runs every round, not one: ``migrate_round.launches``
    counts launches, one per growth, and the plain version is
    :func:`migrate_plain`, not :func:`migrate_round_plain`."""
    _check_table(old_keys, old_values)
    _check_table(new_keys, new_values)
    if new_keys.shape[0] != old_keys.shape[0] \
            or new_keys.device != old_keys.device:
        raise ValueError("old and new tables must have one shard count "
                         "and one device")
    if not _on_card(old_keys):
        return migrate_plain(old_keys, old_values, new_keys, new_values,
                             max_probes=max_probes)
    _check_aligned(new_keys, "keys")
    from .. import kernels

    n_old = old_keys.shape[0] * old_keys.shape[1]
    n_new = new_keys.shape[0] * new_keys.shape[1]
    if claim is None or claim.dtype != torch.int32 \
            or claim.shape != (n_new,) or claim.device != new_keys.device:
        raise ValueError("the kernel needs the new table's claim vector")
    dev = old_keys.device
    # per old slot the slot it claimed last, and two lists of the keys
    # still pending (i32); the kernel's flags and result
    gslot = torch.empty(n_old, dtype=torch.int32, device=dev)
    lists = torch.empty(2 * n_old, dtype=torch.int32, device=dev)
    ctl = torch.empty(6, dtype=torch.int32, device=dev)
    lib = kernels.library("dedup_probe")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bkw_dedup_migrate(
            old_keys.data_ptr(), old_values.data_ptr(), n_old,
            old_keys.shape[1], new_keys.data_ptr(), new_values.data_ptr(),
            new_keys.shape[1], n_new, max_probes, gslot.data_ptr(),
            lists.data_ptr(), claim.data_ptr(), ctl.data_ptr(), stream)
    kernels.check_launch(rc, "dedup_probe")
    migrate_round.launches += 1
    return ctl[4:]


probe_table.launches = 0
insert_table.launches = 0
migrate_round.launches = 0


# --- the table ---------------------------------------------------------------


def _empty_table(n_shards: int, capacity: int, device: torch.device):
    keys = torch.zeros((n_shards, capacity, KEY_WORDS), dtype=torch.int32,
                       device=device)
    values = torch.zeros((n_shards, capacity), dtype=torch.int32,
                         device=device)
    claim = None
    if device.type == "cuda":
        claim = torch.full((n_shards * capacity,), -1, dtype=torch.int32,
                           device=device)
    return keys, values, claim


@dataclass
class ShardedDedupIndex:
    """Sharded hash table on one device; ``keys``/``values`` are updated
    in place by inserts (the JAX table is functional and donates its
    buffers, which amounts to the same)."""

    n_shards: int
    capacity: int  # slots per shard
    keys: torch.Tensor  # (D, capacity, KEY_WORDS) int32 (u32 bits), 0 = empty
    values: torch.Tensor  # (D, capacity) int32 (u32 bits)
    max_probes: int
    # the kernel's per-slot claim vector (CUDA only), all -1 between calls
    claim: Optional[torch.Tensor] = field(default=None, repr=False,
                                          compare=False)
    # the insert kernel's scratch (CUDA only); after an insert,
    # ``scratch.rounds_run()`` says how many rounds its launch ran
    scratch: Optional[InsertScratch] = field(default=None, repr=False,
                                             compare=False)

    @classmethod
    def create(cls, n_shards: int = 1,
               capacity: int = defaults.DEDUP_SHARD_CAPACITY,
               max_probes: int = defaults.DEDUP_MAX_PROBES, device=None):
        if n_shards < 1 or capacity < 1 or max_probes < 1:
            raise ValueError("n_shards, capacity and max_probes must be >= 1")
        device = resolve_device(device)
        keys, values, claim = _empty_table(n_shards, capacity, device)
        scratch = InsertScratch(device) if claim is not None else None
        return cls(n_shards=n_shards, capacity=capacity, keys=keys,
                   values=values, max_probes=max_probes, claim=claim,
                   scratch=scratch)

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def _queries(self, queries: np.ndarray) -> torch.Tensor:
        q = np.array(queries, dtype=np.uint32).reshape(-1, KEY_WORDS)
        return torch.from_numpy(q.view(np.int32)).to(self.device)

    def probe(self, queries: np.ndarray) -> np.ndarray:
        """found[i] = value+1 if present else 0 (u32)."""
        found = self.probe_device(self._queries(queries))
        return found.cpu().numpy().view(np.uint32)

    def insert(self, queries: np.ndarray, values: np.ndarray) -> np.ndarray:
        """Insert new keys (found keys keep their value); returns the same
        found-vector as probe (pre-insert state).  Lanes that still lost a
        race after the on-device retries are retried here, so a returned
        0 ("new") always ends with the key resident."""
        queries = np.asarray(queries, dtype=np.uint32).reshape(-1, KEY_WORDS)
        values = np.asarray(values, dtype=np.uint32).reshape(-1)
        out = np.zeros(queries.shape[0], dtype=np.uint32)
        pending = np.arange(queries.shape[0])
        first = True
        while pending.size:
            found, lost = self._insert_once(queries[pending], values[pending])
            if np.any(lost == LOST_EXHAUSTED):
                raise DedupIndexFull(
                    f"linear probe exhausted after {self.max_probes} steps; "
                    f"shard too full/clustered -- resize capacity "
                    f"(currently {self.capacity}/shard)")
            if first:
                out[pending] = found
                first = False
            pending = pending[lost == LOST_RACE]
        return out

    def _insert_once(self, queries: np.ndarray, values: np.ndarray):
        v = torch.from_numpy(np.array(values, dtype=np.uint32).view(
            np.int32)).to(self.device)
        found, lost = self.insert_device(self._queries(queries), v)
        return (found.cpu().numpy().view(np.uint32),
                lost.cpu().numpy().view(np.uint32))

    def insert_device(self, q_dev: torch.Tensor, v_dev: torch.Tensor):
        """Device-resident insert of ``(..., 4)`` int32 queries with one
        int32 value each: returns ``(found, lost)`` shaped like the
        queries' leading axes, WITHOUT any host synchronization; the retry
        rounds run on the device (nonzero ``lost`` after them means resize
        or resolve on the host; see :meth:`insert`)."""
        lead = q_dev.shape[:-1]
        found, lost = insert_table(
            self.keys, self.values, q_dev.reshape(-1, KEY_WORDS),
            v_dev.reshape(-1), max_probes=self.max_probes, claim=self.claim,
            scratch=self.scratch)
        return found.reshape(lead), lost.reshape(lead)

    def probe_device(self, q_dev: torch.Tensor) -> torch.Tensor:
        """Device-resident probe of ``(..., 4)`` queries WITHOUT host
        synchronization; ``value+1`` if present else 0."""
        found = probe_table(self.keys, self.values,
                            q_dev.reshape(-1, KEY_WORDS),
                            max_probes=self.max_probes)
        return found.reshape(q_dev.shape[:-1])

    def grown(self, new_capacity: int) -> "ShardedDedupIndex":
        """Larger copy with the resident keys re-hashed on the device:
        shard routing depends only on the hash words, so every key stays
        on its shard.  One :func:`migrate_round` call (on the card one
        launch) and one host read of its result; the old table is left
        as it was."""
        if new_capacity <= self.capacity:
            raise ValueError("grown() requires a larger capacity")
        nk, nv, claim = _empty_table(self.n_shards, new_capacity, self.device)
        _rounds, exhausted = migrate_round(
            self.keys, self.values, nk, nv, max_probes=self.max_probes,
            claim=claim).tolist()
        if exhausted:
            raise DedupIndexFull("migration exhausted probes; grow further")
        return ShardedDedupIndex(
            n_shards=self.n_shards, capacity=new_capacity, keys=nk,
            values=nv, max_probes=self.max_probes, claim=claim,
            scratch=self.scratch)

    def dump(self):
        """Every live entry on the host: ``(M, 4)`` u32 keys and ``(M,)``
        u32 values (empty slots dropped)."""
        keys = self.keys.cpu().numpy().view(np.uint32).reshape(-1, KEY_WORDS)
        values = self.values.cpu().numpy().view(np.uint32).reshape(-1)
        live = keys.any(axis=1)
        return keys[live], values[live]
