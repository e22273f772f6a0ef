"""Zero-round-trip manifest: scan -> select -> chunk meta -> pool digest.

Port of the leaf-pool half of ``backuwup_tpu/ops/manifest_device.py``.
One resident ``(B, 31+P)`` batch goes through the CDC scan kernel and the
on-device cut selection (:func:`.cdc_gpu.scan_select_batch`), chunk
offsets and lengths are derived on the device from the packed cut rows
(:func:`_chunk_meta`), and every chunk is digested by one leaf-pool pass
(:func:`.digest_pool.pool_digest`).  The caller downloads the packed cuts,
the digest accumulator and the overflow count once per batch.  With
``emit_queries`` the batch also yields its dedup query slab, a view of the
accumulator (the JAX mesh program's ``emit_queries``), so fingerprints
flow manifest -> dedup table without leaving the device.

The JAX package's class-tile digest (``scan_digest_batch``) is not
ported: it exists to amortise TPU dispatch overhead.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .blake3_cpu import CHUNK_LEN
from .cdc_gpu import _HALO, scan_select_batch
from .dedup_index import queries_from_cvs
from .digest_pool import pool_digest, tier_caps, tier_spans
from .gear import CDCParams


@functools.lru_cache(maxsize=16)
def _length_histogram(params: CDCParams) -> Tuple[float, Tuple[float, ...]]:
    """(mean chunk length, fraction per leaf class), computed analytically
    from the two-phase geometric cut process on uniform data.  It only
    sizes capacities; data far from it overflows, which is detected."""
    p_s = 2.0 ** -params.mask_s_bits
    p_l = 2.0 ** -params.mask_l_bits
    lens = np.arange(params.min_size, params.max_size + 1, dtype=np.float64)
    a = np.clip(lens - params.min_size + 1, 0,
                params.desired_size - params.min_size)
    b = np.clip(lens - params.desired_size + 1, 0, None)
    surv = (1 - p_s) ** a * (1 - p_l) ** b
    pmf = np.empty_like(surv)
    pmf[:-1] = surv[:-1] - surv[1:]
    pmf[-1] = surv[-1]  # forced cut at max_size absorbs the tail
    pmf = np.maximum(pmf, 0)
    pmf /= pmf.sum()
    mean = float((lens * pmf).sum())
    classes = class_leaf_sizes(params)
    leaves = -(-lens // CHUNK_LEN)
    fracs = []
    for i, c in enumerate(classes):
        lo = classes[i - 1] if i else 0
        fracs.append(float(pmf[(leaves > lo) & (leaves <= c)].sum()))
    return mean, tuple(fracs)


@functools.lru_cache(maxsize=16)
def class_leaf_sizes(params: CDCParams) -> Tuple[int, ...]:
    """Linear leaf-count class grid covering [1, max chunk leaves]."""
    max_leaves = -(-params.max_size // CHUNK_LEN)
    step = max(8, -(-max_leaves // 12))
    step = -(-step // 8) * 8
    out = list(range(step, max_leaves + 1, step))
    if not out or out[-1] != max_leaves:
        out.append(max_leaves)
    return tuple(out)


@functools.lru_cache(maxsize=64)
def tier_plan(params: CDCParams, total_bytes: int,
              n_rows: int) -> Tuple[Tuple[int, int], ...]:
    """((leaf_span, chunk_cap), ...) tree tiers for the leaf-pool digest,
    from the analytic length histogram re-binned onto the tier spans."""
    mean_len, fracs = _length_histogram(params)
    classes = class_leaf_sizes(params)
    spans = tier_spans(-(-params.max_size // CHUNK_LEN))
    return tier_caps(spans, tuple(zip(classes, fracs)),
                     total_bytes / max(mean_len, 1.0), n_rows)


def _chunk_meta(packed: torch.Tensor, row_len: int):
    """Packed cut rows -> flat per-chunk (abs offset, length, valid), all
    ``(B*cut_cap,)``.  Rows whose scan overflowed are masked out (the
    caller redoes them), so they cannot take digest capacity."""
    B = packed.shape[0]
    cut_cap = packed.shape[1] - 2
    packed = packed.to(torch.int64)
    n_cuts = packed[:, 1]
    ends = packed[:, 2:]
    offs = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1] + 1], dim=1)
    lens = ends - offs + 1
    slot = torch.arange(cut_cap, dtype=torch.int64, device=packed.device)
    valid = (slot[None, :] < n_cuts[:, None]) & (packed[:, :1] == 0)
    lens = torch.where(valid, lens, 0)
    row_base = (torch.arange(B, dtype=torch.int64, device=packed.device)
                * row_len + _HALO)[:, None]
    return ((row_base + offs).reshape(-1), lens.reshape(-1),
            valid.reshape(-1))


def scan_digest_batch_pool(buf_d: torch.Tensor, nv_b: torch.Tensor, *,
                           min_size: int, desired_size: int, max_size: int,
                           mask_s: int, mask_l: int, s_cap: int, l_cap: int,
                           cut_cap: int, leaf_cap: int,
                           tiers: Tuple[Tuple[int, int], ...],
                           emit_queries: bool = False):
    """One resident ``(B, 31+P)`` batch -> ``(packed, acc, ovf)``:
    ``packed`` (B, 2+cut_cap) int32 cut rows, ``acc`` (B*cut_cap, 8) int32
    root CVs addressed by ``row*cut_cap + chunk``, ``ovf`` (1,) the chunks
    the pool could not digest (nonzero: the caller redoes the batch).
    With ``emit_queries`` a fourth output: the ``(1, B*cut_cap, 4)`` dedup
    query view of ``acc`` (:func:`.dedup_index.queries_from_cvs`)."""
    row_len = buf_d.shape[1]
    packed = scan_select_batch(
        buf_d, nv_b, min_size=min_size, desired_size=desired_size,
        max_size=max_size, mask_s=mask_s, mask_l=mask_l,
        s_cap=s_cap, l_cap=l_cap, cut_cap=cut_cap)
    abs_offs, flat_lens, _ = _chunk_meta(packed, row_len)
    flat = torch.cat([buf_d.reshape(-1), buf_d.new_zeros(CHUNK_LEN)])
    acc, ovf = pool_digest(flat, abs_offs, flat_lens, leaf_cap=leaf_cap,
                           tiers=tiers)
    if emit_queries:
        return packed, acc, ovf, queries_from_cvs(acc)[None]
    return packed, acc, ovf
