"""Cold tier: a bucketed LSM-style host/disk fingerprint store.

Counterpart of ``backuwup_tpu/dedupstore/cold.py``.  Host numpy and files
on disk only; the run file format is byte-identical, so each package
opens the other's cold directory.

Fingerprints that do not fit the hot HBM table (dedupstore/tiered.py)
live here as sorted immutable runs plus an in-memory memtable, in the
classic LSM arrangement (the reference keeps its whole index host-side;
this store keeps only the cold overflow).  One record is the 16-byte
truncated fingerprint — the same 4-word key the device table probes
(``ops/dedup_index.py``, on the device) — plus a u32 value, 20 bytes total.

Layout of one run file (little-endian):

=============================  ==============================================
region                         contents
=============================  ==============================================
header (24 bytes)              ``b"BKWCRUN1"`` magic, u32 bucket count,
                               u32 input count, u64 record count
input seqs                     u64 per input: the runs this run replaced
                               (compaction provenance — recovery rolls the
                               make-before-break cleanup forward)
skip words                     u64 per bucket: bloom-style filter, one bit
                               per key's second word (``w1 & 63``) — a
                               query whose bit is unset skips the run
                               without touching a record
bucket directory               u64 per bucket: record count per prefix
                               bucket (top bits of the first key word)
records                        count x 20 bytes, sorted ascending by the
                               big-endian serialized key
=============================  ==============================================

Keys serialize big-endian per word so plain byte order sorts like the
``(w0, w1, w2, w3)`` tuple and the first key word is the literal byte
prefix — runs are therefore prefix-bucketed by construction, and
:meth:`ColdFingerprintStore.classify` answers a whole query batch with
one vectorized binary search per run after the skip words drop the
definite absents.

Durability follows ALICE discipline (PAPERS.md): a run becomes visible
only via ``durable.commit_replace`` (fsync tmp, rename, fsync dir) with
``faults.crashpoint`` seams on both sides, and compaction is
make-before-break — the merged run records its inputs' seqs, so a crash
between commit and input cleanup is rolled forward on the next open.
The memtable is volatile by design: the tiered front only drops a key
from the hot table after :meth:`flush` made it durable here, and every
other memtable entry is reconstructible from the BlobIndex authority.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import defaults
from ..obs import profile as obs_profile
from ..utils import durable, faults

_MAGIC = b"BKWCRUN1"
_HEADER = struct.Struct("<8sIIQ")
RECORD_DTYPE = np.dtype([("key", "S16"), ("value", "<u4")])

# Crash seams on the two durable commits (bkwlint BKW003: registered at
# import, one crashpoint call on each side of each commit_replace).
_CP_RUN_PRE = faults.register_crash_site("tier.run.commit.pre")
_CP_RUN_POST = faults.register_crash_site("tier.run.commit.post")
_CP_COMPACT_PRE = faults.register_crash_site("tier.compact.commit.pre")
_CP_COMPACT_POST = faults.register_crash_site("tier.compact.commit.post")


def pack_keys(queries: np.ndarray) -> np.ndarray:
    """``(N, 4)`` u32 query words -> ``(N,)`` S16 sortable keys.

    Big-endian per word, so lexicographic byte order equals numeric
    ``(w0, w1, w2, w3)`` order (numpy's trailing-NUL-stripping bytes
    semantics preserve both order and distinctness for fixed-width
    originals padded with the minimal byte).
    """
    q = np.ascontiguousarray(np.asarray(queries, dtype=np.uint32))
    if q.size == 0:
        return np.empty(0, dtype="S16")
    return q.reshape(-1, 4).astype(">u4").reshape(-1).view("S16")


def unpack_keys(keys: np.ndarray) -> np.ndarray:
    """``(N,)`` S16 keys -> ``(N, 4)`` u32 query words (inverse of
    :func:`pack_keys`)."""
    if len(keys) == 0:
        return np.zeros((0, 4), dtype=np.uint32)
    # field views of structured arrays are strided: repack first
    fixed = np.ascontiguousarray(np.asarray(keys, dtype="S16"))
    raw = fixed.view(">u4").reshape(-1, 4)
    return raw.astype(np.uint32)


class _Run:
    """One sorted immutable run, records memory-mapped read-only."""

    def __init__(self, path: Path):
        self.path = path
        self.seq = int(path.stem[1:])
        with path.open("rb") as f:
            head = f.read(_HEADER.size)
            if len(head) != _HEADER.size:
                raise ValueError(f"truncated run header: {path}")
            magic, n_buckets, n_inputs, count = _HEADER.unpack(head)
            if magic != _MAGIC:
                raise ValueError(f"bad run magic in {path}: {magic!r}")
            self.count = count
            self.inputs: Tuple[int, ...] = tuple(
                np.frombuffer(f.read(8 * n_inputs), dtype="<u8").tolist())
            self.skip = np.frombuffer(
                f.read(8 * n_buckets), dtype="<u8").copy()
            self.bucket_counts = np.frombuffer(
                f.read(8 * n_buckets), dtype="<u8").copy()
            offset = f.tell()
        self.records = np.memmap(path, dtype=RECORD_DTYPE, mode="r",
                                 offset=offset, shape=(count,))

    @property
    def n_buckets(self) -> int:
        return len(self.skip)


def _encode_run(records: np.ndarray, n_buckets: int,
                inputs: Sequence[int]) -> bytes:
    """Serialize sorted records into one run blob (header + filters +
    bucket directory + records)."""
    shift = 32 - (n_buckets.bit_length() - 1)
    keys_w = unpack_keys(records["key"])
    if len(keys_w):
        buckets = (keys_w[:, 0] >> np.uint32(shift)).astype(np.int64)
        bits = (keys_w[:, 1] & np.uint32(63)).astype(np.uint64)
        skip = np.zeros(n_buckets, dtype="<u8")
        np.bitwise_or.at(skip, buckets, np.uint64(1) << bits)
        counts = np.bincount(buckets, minlength=n_buckets).astype("<u8")
    else:
        skip = np.zeros(n_buckets, dtype="<u8")
        counts = np.zeros(n_buckets, dtype="<u8")
    head = _HEADER.pack(_MAGIC, n_buckets, len(inputs), len(records))
    return b"".join([
        head,
        np.asarray(list(inputs), dtype="<u8").tobytes(),
        skip.tobytes(), counts.tobytes(),
        np.ascontiguousarray(records).tobytes(),
    ])


class ColdFingerprintStore:
    """Batched membership over memtable + sorted runs, newest wins.

    ``classify(queries)`` takes the same ``(N, 4)`` u32 query rows the
    device table probes and returns a ``(N,)`` u32 vector — ``value + 1``
    for present keys, 0 for absent keys and all-zero padding rows (the
    device table's found-vector convention, so the tiered front can
    merge the two answers without translation).
    """

    def __init__(self, root: Path, *,
                 memtable_limit: Optional[int] = None,
                 n_buckets: Optional[int] = None,
                 compact_fanin: Optional[int] = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.memtable_limit = memtable_limit \
            or defaults.DEDUP_COLD_MEMTABLE_LIMIT
        self.n_buckets = n_buckets or defaults.DEDUP_COLD_BUCKETS
        if self.n_buckets & (self.n_buckets - 1):
            raise ValueError("n_buckets must be a power of two")
        self.compact_fanin = compact_fanin \
            or defaults.DEDUP_COLD_COMPACT_FANIN
        self._memtable: Dict[bytes, int] = {}
        self._runs: List[_Run] = []
        self._recover()

    # --- recovery replay -----------------------------------------------------

    def _recover(self) -> None:
        """Scan the run directory into a consistent run set.

        Uncommitted ``.tmp`` leftovers are dropped; a committed merged
        run whose inputs still exist (crash between compaction commit
        and cleanup) rolls forward by deleting the inputs — the merged
        run holds every surviving record, so replay is idempotent.
        """
        for tmp in self.root.glob("*.tmp"):
            tmp.unlink()
        runs = sorted((_Run(p) for p in self.root.glob("r*.run")),
                      key=lambda r: r.seq)
        by_seq = {r.seq: r for r in runs}
        stale: set = set()
        for r in runs:
            for seq in r.inputs:
                if seq in by_seq:
                    stale.add(seq)
        for seq in stale:
            by_seq[seq].path.unlink(missing_ok=True)
        self._runs = [r for r in runs if r.seq not in stale]
        self._next_seq = max((r.seq for r in runs), default=-1) + 1
        self._note_state()

    # --- ingest --------------------------------------------------------------

    def insert(self, queries: np.ndarray,
               values: Optional[np.ndarray] = None) -> None:
        """Buffer ``(N, 4)`` query rows into the memtable (all-zero
        padding rows skipped); flushes a run when the memtable fills."""
        q = np.asarray(queries, dtype=np.uint32).reshape(-1, 4)
        if values is None:
            vals = np.ones(len(q), dtype=np.uint32)
        else:
            vals = np.asarray(values, dtype=np.uint32).reshape(-1)
        live = q.any(axis=1)
        packed = pack_keys(q[live])
        for k, v in zip(packed.tolist(), vals[live].tolist()):
            self._memtable[k] = v
        if len(self._memtable) >= self.memtable_limit:
            self.flush()
        else:
            self._note_state()

    def flush(self) -> None:
        """Commit the memtable as a new sorted run (crash-safe), then
        fold same-size runs per the size-tiered policy."""
        if self._memtable:
            records = np.empty(len(self._memtable), dtype=RECORD_DTYPE)
            records["key"] = np.array(list(self._memtable.keys()),
                                      dtype="S16")
            records["value"] = np.fromiter(
                self._memtable.values(), dtype=np.uint32,
                count=len(self._memtable))
            records.sort(order="key")
            self._commit_run(records, kind="flush", inputs=())
            self._memtable.clear()
        self._maybe_compact()
        self._note_state()

    def _commit_run(self, records: np.ndarray, kind: str,
                    inputs: Sequence[int]) -> _Run:
        seq = self._next_seq
        self._next_seq += 1
        path = self.root / f"r{seq:012d}.run"
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(_encode_run(records, self.n_buckets, inputs))
        if kind == "flush":
            faults.crashpoint(_CP_RUN_PRE)
            durable.commit_replace(tmp, path)
            faults.crashpoint(_CP_RUN_POST)
        else:
            faults.crashpoint(_CP_COMPACT_PRE)
            durable.commit_replace(tmp, path)
            faults.crashpoint(_CP_COMPACT_POST)
        run = _Run(path)
        self._runs.append(run)
        obs_profile.tier_cold_commit(kind)
        return run

    # --- size-tiered compaction ----------------------------------------------

    @staticmethod
    def _tier_of(count: int) -> int:
        # log4 of record count: one merged run of fanin=4 same-size
        # inputs lands one tier up, so tiers stay geometrically spaced
        return max(count, 1).bit_length() // 2

    def _maybe_compact(self) -> None:
        while True:
            tiers: Dict[int, List[_Run]] = {}
            for run in self._runs:
                tiers.setdefault(self._tier_of(run.count), []).append(run)
            victims = next((rs for rs in tiers.values()
                            if len(rs) >= self.compact_fanin), None)
            if victims is None:
                return
            self._compact(victims)

    def _compact(self, victims: List[_Run]) -> None:
        """Merge ``victims`` into one run, newest value winning, then
        drop the inputs (make-before-break: the merged run commits with
        the input seqs in its header before anything is deleted)."""
        newest_first = sorted(victims, key=lambda r: -r.seq)
        merged = np.concatenate(
            [np.asarray(r.records) for r in newest_first])
        order = np.argsort(merged["key"], kind="stable")
        merged = merged[order]
        keep = np.ones(len(merged), dtype=bool)
        keep[1:] = merged["key"][1:] != merged["key"][:-1]
        self._commit_run(merged[keep], kind="compact",
                         inputs=tuple(r.seq for r in victims))
        for r in victims:
            r.path.unlink(missing_ok=True)
        gone = {r.seq for r in victims}
        self._runs = [r for r in self._runs if r.seq not in gone]

    # --- batched classify ----------------------------------------------------

    def classify(self, queries: np.ndarray) -> np.ndarray:
        """``(N, 4)`` u32 query rows -> ``(N,)`` u32: ``value + 1`` for
        present keys, 0 for absent keys and all-zero padding rows."""
        q = np.asarray(queries, dtype=np.uint32).reshape(-1, 4)
        out = np.zeros(len(q), dtype=np.uint32)
        open_idx = np.flatnonzero(q.any(axis=1))
        if open_idx.size == 0:
            return out
        packed = pack_keys(q[open_idx])
        # memtable first (newest layer)
        mem = self._memtable
        if mem:
            misses = []
            for i, key in enumerate(packed.tolist()):
                v = mem.get(key)
                if v is None:
                    misses.append(i)
                else:
                    out[open_idx[i]] = v + 1
            if not misses:
                return out
            sel = np.asarray(misses, dtype=np.int64)
            open_idx, packed = open_idx[sel], packed[sel]
        shift = 32 - (self.n_buckets.bit_length() - 1)
        w = q[open_idx]
        buckets = (w[:, 0] >> np.uint32(shift)).astype(np.int64)
        bits = (w[:, 1] & np.uint32(63)).astype(np.uint64)
        for run in sorted(self._runs, key=lambda r: -r.seq):
            if run.count == 0 or open_idx.size == 0:
                continue
            # bloom-style skip words: definite absents never touch a
            # record page
            cand = np.flatnonzero(
                (run.skip[buckets] >> bits) & np.uint64(1))
            if cand.size == 0:
                continue
            pos = np.searchsorted(run.records["key"], packed[cand])
            inb = pos < run.count
            hitm = np.zeros(cand.size, dtype=bool)
            if inb.any():
                sub = cand[inb]
                hitm[inb] = run.records["key"][pos[inb]] == packed[sub]
            if hitm.any():
                hits = cand[hitm]
                out[open_idx[hits]] = \
                    run.records["value"][pos[hitm]] + 1
                keepm = np.ones(open_idx.size, dtype=bool)
                keepm[hits] = False
                open_idx, packed = open_idx[keepm], packed[keepm]
                buckets, bits = buckets[keepm], bits[keepm]
        return out

    # --- lifecycle -----------------------------------------------------------

    def reset(self) -> None:
        """Drop every run and the memtable (tiered front reconcile: the
        cold tier is a cache of the BlobIndex authority, and a detected
        stale key invalidates the whole store rather than risking a
        pruned fingerprint classifying as duplicate).  Seqs stay
        monotonic so no later run can alias a deleted one."""
        for r in self._runs:
            r.path.unlink(missing_ok=True)
        self._runs = []
        self._memtable.clear()
        self._note_state()

    # --- introspection -------------------------------------------------------

    @property
    def run_count(self) -> int:
        return len(self._runs)

    def __len__(self) -> int:
        """Records across runs + memtable (cross-run duplicates counted
        until compaction merges them — an upper bound on unique keys)."""
        return len(self._memtable) + sum(r.count for r in self._runs)

    def known_queries(self) -> np.ndarray:
        """All distinct keys as ``(N, 4)`` u32 rows, newest-wins
        deduplicated (seeding helper for the tiered front)."""
        layers = [np.array(list(self._memtable.keys()), dtype="S16")]
        layers += [np.asarray(r.records["key"])
                   for r in sorted(self._runs, key=lambda r: -r.seq)]
        keys = np.concatenate(layers) if layers else \
            np.empty(0, dtype="S16")
        return unpack_keys(np.unique(keys))

    def _note_state(self) -> None:
        obs_profile.tier_cold_state(len(self._runs), len(self))
