"""Carry reference state into the port.

This system holds no weights: its state is the chunking configuration,
the gear table, the dedup table and the tiered dedup front around it.
These helpers take them from a reference object or its arrays (read by
attribute or as numpy, so nothing of the JAX package is imported) and
check them.  On-disk state (packfiles, index files, cold runs) needs no
converter: the formats are the same.
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from .dedupstore.cold import ColdFingerprintStore
from .dedupstore.tiered import TieredDedupIndex
from .ops.cdc_gpu import _HALO
from .ops.dedup_index import KEY_WORDS, ShardedDedupIndex
from .ops.gear import GEAR, CDCParams
from .utils.device import resolve_device


def cdc_params_from_reference(p) -> CDCParams:
    """The port's ``CDCParams`` with the five fields of a reference one."""
    return CDCParams(min_size=int(p.min_size),
                     desired_size=int(p.desired_size),
                     max_size=int(p.max_size),
                     mask_s_bits=int(p.mask_s_bits),
                     mask_l_bits=int(p.mask_l_bits))


def gear_table_matches(ref_gear: np.ndarray) -> bool:
    """Raise unless the reference's 256-entry gear table equals the port's."""
    ref = np.asarray(ref_gear)
    if ref.shape != GEAR.shape or not np.array_equal(
            ref.astype(np.uint32), GEAR):
        raise ValueError("gear table differs from the reference")
    return True


def batch_from_reference(buf: np.ndarray, nv: np.ndarray, device=None):
    """A reference ``(B, 31+P)`` u8 batch and its ``(B,)`` valid lengths
    -> the port's ``(ext_b, nv_b)`` tensors on ``device``."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    nv = np.ascontiguousarray(nv, dtype=np.int32)
    if buf.ndim != 2 or buf.shape[1] <= _HALO:
        raise ValueError("buf must be (B, 31+P) bytes")
    if nv.shape != (buf.shape[0],):
        raise ValueError("nv must have one length per row")
    if (nv < 0).any() or (nv > buf.shape[1] - _HALO).any():
        raise ValueError("valid lengths out of range")
    dev = resolve_device(device)
    return torch.from_numpy(buf).to(dev), torch.from_numpy(nv).to(dev)


def dedup_table_from_reference(keys: np.ndarray, values: np.ndarray, *,
                               max_probes: int, device=None
                               ) -> ShardedDedupIndex:
    """A reference table's ``(D, capacity, 4)`` u32 keys and ``(D,
    capacity)`` u32 values (``np.asarray(idx.keys)``, ``np.asarray(
    idx.values)``) -> the port's :class:`ShardedDedupIndex` holding the
    same slots, on ``device``."""
    keys = np.array(keys, dtype=np.uint32)  # a writable copy
    values = np.array(values, dtype=np.uint32)
    if keys.ndim != 3 or keys.shape[2] != KEY_WORDS:
        raise ValueError("keys must be (D, capacity, 4)")
    if values.shape != keys.shape[:2]:
        raise ValueError("values must be (D, capacity)")
    idx = ShardedDedupIndex.create(keys.shape[0], capacity=keys.shape[1],
                                   max_probes=max_probes, device=device)
    idx.keys.copy_(torch.from_numpy(keys.view(np.int32)))
    idx.values.copy_(torch.from_numpy(values.view(np.int32)))
    return idx


def tiered_from_reference(ref, host_index, cold_dir: Path,
                          device=None) -> TieredDedupIndex:
    """The port's :class:`TieredDedupIndex` in the state of a reference
    one (``backuwup_tpu.dedupstore.TieredDedupIndex``): the same hot
    table slot for slot, capacity, budget and clock settings, recency
    order, heat counters and promotion queue, over ``host_index`` as its
    authority.  ``cold_dir`` holds the reference's cold runs (its own
    directory or a copy) and is opened in place; the reference's memtable,
    which is volatile by design, is copied."""
    keys = np.asarray(ref.sharded.keys)
    sharded = dedup_table_from_reference(
        keys, np.asarray(ref.sharded.values),
        max_probes=int(ref.sharded.max_probes), device=device)
    if int(ref.capacity) != keys.shape[1]:
        raise ValueError("the reference front's capacity and table differ")
    front = TieredDedupIndex.__new__(TieredDedupIndex)
    front.host = host_index
    front.n_shards = keys.shape[0]
    front.device = sharded.device
    front.capacity = keys.shape[1]
    front._ones_cache = OrderedDict()
    front.sharded = sharded
    front.hbm_budget_bytes = int(ref.hbm_budget_bytes)
    front.clock_windows = int(ref.clock_windows)
    front.promote_min_hits = int(ref.promote_min_hits)
    rc = ref.cold
    front.cold = ColdFingerprintStore(
        cold_dir, memtable_limit=int(rc.memtable_limit),
        n_buckets=int(rc.n_buckets), compact_fanin=int(rc.compact_fanin))
    front.cold._memtable = dict(rc._memtable)
    front._windows = int(ref._windows)
    front._saw_dispatch = bool(ref._saw_dispatch)
    front._cold_hits = dict(ref._cold_hits)
    front._promote_queue = dict(ref._promote_queue)
    front._recent = OrderedDict(ref._recent)
    front._note_hbm()
    return front
