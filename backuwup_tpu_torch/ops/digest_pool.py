"""Flat leaf-pool BLAKE3: digest every chunk of a batch in one leaf scan.

Port of ``backuwup_tpu/ops/digest_pool.py``.  Every chunk is decomposed
into its 1 KiB BLAKE3 leaves, one flat pool of leaves goes through ONE
launch of the leaf kernel (:func:`.blake3_gpu.leaf_scan`), and the leaf
chaining values are pair-merged per chunk in 2-3 geometric leaf-count
tiers.  Lane ownership is one scatter-max of chunk ids at each chunk's
first lane plus a running max (``torch.cummax``); nothing syncs the host.
Tier capacities cascade upward; a chunk the terminus cannot place, or a
pool-lane shortfall, is counted in the overflow output and the caller
re-digests the batch another way (bit-exact either way).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from .blake3_cpu import BLOCK_LEN, CHUNK_LEN
from .blake3_gpu import (
    _bytes_to_words,
    _ceil_div,
    leaf_scan,
    root_single,
    tree_reduce_cvs,
)
from .u32 import from_bits, to_bits


@functools.lru_cache(maxsize=32)
def tier_spans(max_leaves: int, n_tiers: int = 3) -> Tuple[int, ...]:
    """Geometric leaf-count tier grid ending at ``max_leaves``."""
    spans = [max_leaves]
    while len(spans) < n_tiers and spans[-1] > 8:
        spans.append(max(8, -(-spans[-1] // 2 // 8) * 8))
    return tuple(reversed([s for i, s in enumerate(spans)
                           if i == 0 or s < spans[i - 1]]))


def leaf_capacity(total_padded_bytes: int, max_chunks: int) -> int:
    """Structural upper bound on pool lanes: every payload byte plus at
    most one partial leaf per chunk."""
    cap = total_padded_bytes // CHUNK_LEN + max_chunks
    return -(-cap // 512) * 512


@functools.lru_cache(maxsize=64)
def tier_caps(spans: Tuple[int, ...], fracs_by_leaves, expect_total: float,
              n_extra: int) -> Tuple[Tuple[int, int], ...]:
    """Capacity per tier from a (leaf-count -> fraction) histogram:
    expectation + 0.75 sigma; the terminus carries the slack plus
    ``n_extra`` (short per-row tails land in tier 0)."""
    out = []
    for i, span in enumerate(spans):
        lo = spans[i - 1] if i else 0
        frac = sum(f for ml, f in fracs_by_leaves if lo < ml <= span)
        mu = expect_total * frac
        sigma = (max(mu, 0.0) * max(1.0 - frac, 0.0)) ** 0.5
        want = mu + 0.75 * sigma + 1 + (n_extra if i == 0 else 0)
        if i == len(spans) - 1:
            want += 8 + 0.02 * expect_total
        out.append((span, -(-int(want) // 4) * 4))
    return tuple(out)


def leaf_plan(flat: torch.Tensor, offs: torch.Tensor, lens: torch.Tensor,
              leaf_cap: int):
    """Pool lanes of ``C`` chunks carved from ``flat``: returns a dict with
    the leaf-kernel inputs ``words`` (leaf_cap, 256) int32, ``nb``,
    ``lbl``, ``counter`` (leaf_cap,) int32, and the per-chunk ``lv``
    (leaves), ``base`` (first lane), ``valid`` and ``pool_short``."""
    dev = flat.device
    C = offs.shape[0]
    offs = offs.to(torch.int64)
    lens = lens.to(torch.int64)
    valid = lens > 0
    lv = torch.where(valid, _ceil_div(lens, CHUNK_LEN), 0)
    base = torch.cumsum(lv, dim=0) - lv
    pool_short = (base[-1] + lv[-1] - leaf_cap).clamp(min=0)

    # ownership fill: one scatter-max + running max
    start_idx = torch.where(valid, base.clamp(max=leaf_cap - 1), leaf_cap)
    marker = torch.full((leaf_cap + 1,), -1, dtype=torch.int64, device=dev)
    marker.scatter_reduce_(0, start_idx,
                           torch.arange(C, dtype=torch.int64, device=dev),
                           reduce="amax")
    owner = torch.cummax(marker[:leaf_cap], dim=0).values
    oc = owner.clamp(0, C - 1)
    lane = torch.arange(leaf_cap, dtype=torch.int64, device=dev)
    k = lane - base[oc]
    active = (owner >= 0) & (k < lv[oc])
    nbytes = torch.where(active, (lens[oc] - k * CHUNK_LEN).clamp(0, CHUNK_LEN),
                         0)

    # one 1 KiB gather per lane from a sliding view of the flat pool
    off = torch.where(active, offs[oc] + k * CHUNK_LEN, 0)
    data = flat.unfold(0, CHUNK_LEN, 1)[off]
    col = torch.arange(CHUNK_LEN, dtype=torch.int64, device=dev)
    data = torch.where(col[None, :] < nbytes[:, None], data, 0).to(torch.uint8)
    nb = _ceil_div(nbytes, BLOCK_LEN).clamp(min=1)
    lbl = nbytes - (nb - 1) * BLOCK_LEN
    return {
        "words": _bytes_to_words(data),
        "nb": nb.to(torch.int32),
        "lbl": lbl.to(torch.int32),
        "counter": k.clamp(min=0).to(torch.int32),
        "lv": lv, "base": base, "valid": valid, "pool_short": pool_short,
    }


def pool_digest(flat: torch.Tensor, offs: torch.Tensor, lens: torch.Tensor, *,
                leaf_cap: int, tiers: Tuple[Tuple[int, int], ...]):
    """Digest ``C`` chunks carved from one resident byte pool.

    ``flat``: (N,) u8 with >= 1024 slack bytes after the last chunk;
    ``offs``/``lens``: (C,) absolute byte offsets / lengths (len <= 0 marks
    an unused slot).  ``tiers``: ((leaf_span, chunk_capacity), ...)
    ascending by span; the last span must be >= the largest leaf count.

    Returns ``((C, 8) int32 root chaining values, (1,) int64 overflow)``.
    """
    dev = flat.device
    C = offs.shape[0]
    plan = leaf_plan(flat, offs, lens, leaf_cap)
    words, lv, base, valid = (plan["words"], plan["lv"], plan["base"],
                              plan["valid"])
    cv_mat, cvpre_mat = leaf_scan(words, plan["nb"], plan["lbl"],
                                  plan["counter"])
    nb = plan["nb"].to(torch.int64)
    lbl = plan["lbl"].to(torch.int64)
    # slack rows so fixed-span tier gathers never run off the end
    top_span = tiers[-1][0]
    cv_pool = from_bits(torch.cat(
        [cv_mat, cv_mat.new_zeros(top_span, 8)], dim=0))

    cls = torch.zeros(C, dtype=torch.int64, device=dev)
    for span, _cap in tiers[:-1]:
        cls = cls + (lv > span).to(torch.int64)
    acc = torch.zeros(C + 1, 8, dtype=torch.int32, device=dev)
    carry = torch.zeros(C, dtype=torch.bool, device=dev)
    for i, (span, cap) in enumerate(tiers):
        if cap == 0:
            carry = carry | (valid & (cls == i))
            continue
        mine = valid & ((cls == i) | carry)
        rank = torch.cumsum(mine, dim=0) - 1
        take = mine & (rank < cap)
        carry = mine & ~take
        # slot of each placed chunk; unplaced lanes go to the sentinel
        idx = torch.full((cap + 1,), C, dtype=torch.int64, device=dev)
        idx.scatter_(0, torch.where(take, rank, cap),
                     torch.arange(C, dtype=torch.int64, device=dev))
        idx = idx[:cap]
        safe = idx.clamp(0, C - 1)
        got = idx < C
        b = torch.where(got, base[safe].clamp(max=leaf_cap - 1), 0)
        cnt = torch.where(got, lv[safe], 1)
        span_i = torch.arange(span, dtype=torch.int64, device=dev)
        leaf_mat = cv_pool[b[:, None] + span_i[None, :]]  # (cap, span, 8)
        leaf_cols = [leaf_mat[:, :, ci] for ci in range(8)]
        rs = root_single(cvpre_mat[b], words[b], nb[b], lbl[b])
        root_seed = [torch.where(cnt == 1, r, 0) for r in rs]
        out_tile = to_bits(tree_reduce_cvs(leaf_cols, cnt, root_seed))
        # fill slots carry idx == C: they land in the sentinel row
        acc.index_copy_(0, idx, out_tile)
    ovf = (carry.sum() + plan["pool_short"]).reshape(1)
    return acc[:C], ovf
