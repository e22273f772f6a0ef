"""Content-defined chunking on the device: candidate scan + cut selection.

Port of ``backuwup_tpu/ops/cdc_tpu.py``.  The per-position rolling hash
``h[i] = ((h[i-1] << 1) + GEAR[b[i]]) mod 2^32`` equals the 32-tap windowed
sum ``h[i] = sum_{k<32} GEAR[b[i-k]] << k``, so every position is hashed
independently.  Candidates (``h & mask == 0``) are packed 32:1 into u32
words by the CUDA scan kernel (:mod:`.scan_fused`), compacted with fixed
capacities, and the FastCDC min/desired/max two-mask cut selection runs
on the device by pointer jumping (:func:`_parallel_select`).  The output
of :func:`scan_select_batch` is the JAX package's packed
``(B, 2+cut_cap)`` row, bit for bit: ``[overflow, n_cuts, ends...]``.

Batched over rows: the JAX package ``vmap``s one row at a time; here a
leading batch axis is written out and every gather is ``torch.gather``
along dim 1.  No step syncs the host: each fixed-capacity
``jnp.nonzero(size=, fill_value=)`` is a cumsum + scatter into a
sentinel slot (:func:`_nonzero_static`).  Position arithmetic is int64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import defaults
from ..utils.device import resolve_device
from .cdc_cpu import cuts_to_chunks, select_cuts
from .gear import GEAR_SEED32, GEAR_WINDOW, CDCParams
from .u32 import M32, mul_const, to_bits

_HALO = GEAR_WINDOW - 1  # 31 bytes of left context carry the full hash state


def _gear_values(b: torch.Tensor) -> torch.Tensor:
    """GEAR[b] per byte as ``fmix32(GEAR_SEED32 + b)``; u8 -> int64 u32."""
    h = b.to(torch.int64) + GEAR_SEED32
    h = h ^ (h >> 16)
    h = mul_const(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul_const(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _hash_ext_fast(ext: torch.Tensor) -> torch.Tensor:
    """Hashes of ``ext[..., _HALO:]`` by five log-doubling passes.

    After pass ``t`` the running array holds ``sum_{k < 2^t} g[i-k] << k``;
    taps before the start of ``ext`` read zero, as in the JAX ladder.
    ``(..., _HALO+L)`` u8 -> ``(..., L)`` int64 u32.
    """
    a = _gear_values(ext)
    for t in range(5):
        s = 1 << t
        zeros = a.new_zeros(*a.shape[:-1], s)
        shifted = torch.cat([zeros, a[..., :-s]], dim=-1)
        a = (a + (shifted << s)) & M32
    return a[..., _HALO:]


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """``(..., L)`` bool -> ``(..., L/32)`` int32 u32 words, bit t of word w
    = position 32w+t (little-endian)."""
    w = bits.reshape(*bits.shape[:-1], -1, 32).to(torch.int64)
    lane = torch.arange(32, dtype=torch.int64, device=bits.device)
    return to_bits((w << lane).sum(dim=-1))


def _candidate_words(h: torch.Tensor, n_valid: torch.Tensor, mask_s: int,
                     mask_l: int):
    """Packed loose/strict candidate words of hashes ``h`` ``(..., L)``;
    positions at or past ``n_valid`` ``(...)`` are never candidates."""
    L = h.shape[-1]
    pos = torch.arange(L, dtype=torch.int64, device=h.device)
    valid = pos < n_valid.to(torch.int64)[..., None]
    cand_l = ((h & mask_l) == 0) & valid
    cand_s = cand_l & ((h & mask_s) == 0)
    return _pack_bits(cand_l), _pack_bits(cand_s)


def _decode_words(wl: np.ndarray, ws: np.ndarray, base_offset: int):
    """Dense candidate words (u32) -> absolute (pos_l, is_s) numpy arrays."""
    widx = np.flatnonzero(wl)
    if widx.size == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=bool)
    bits = np.arange(32, dtype=np.uint32)
    has_l = ((wl[widx, None] >> bits[None, :]) & 1).astype(bool)
    has_s = ((ws[widx, None] >> bits[None, :]) & 1).astype(bool)
    pos = (widx[:, None].astype(np.int64) * 32 + bits[None, :].astype(np.int64)
           + base_offset)
    return pos[has_l], has_s[has_l]


def _round_up(n: int, align: int) -> int:
    return -(-n // align) * align


def _segment_bucket(n: int) -> int:
    """Padded segment length: power-of-two bucket, >= 64 KiB."""
    b = 64 * 1024
    while b < n:
        b *= 2
    return b


class GpuCdcScanner:
    """Chunk one long stream segment by segment with the device scan.

    Each segment (``segment_size`` bytes, padded to its bucket) carries the
    31-byte tail of the previous one as its halo.  The dense candidate
    words come back to the host whole (1/4 byte per stream byte), so no
    sparse capacity can overflow and no segment is ever re-run on the
    oracle; the host then runs the oracle's ``select_cuts`` verbatim.
    """

    def __init__(self, params: Optional[CDCParams] = None,
                 segment_size: int = 128 * defaults.MiB, device=None):
        self.params = params or CDCParams()
        if self.params.min_size < GEAR_WINDOW:
            # the zero halo at a stream start perturbs h[0..30]; harmless
            # only when no cut window reaches below 31
            raise ValueError(f"device chunker requires min_size >= {GEAR_WINDOW}")
        self.segment_size = segment_size
        self.device = resolve_device(device)

    def candidate_positions(self, data, prev_tail: bytes = b""):
        """Sorted absolute (pos_s, pos_l) candidate arrays for ``data``."""
        from .scan_fused import candidate_words

        params = self.params
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
        n = len(arr)
        all_pos, all_s = [], []
        tail = np.frombuffer(bytes(prev_tail)[-_HALO:], dtype=np.uint8)
        offset = 0
        while offset < n:
            seg = arr[offset:offset + self.segment_size]
            padded = _segment_bucket(len(seg))
            ext = np.zeros((1, _HALO + padded), dtype=np.uint8)
            ext[0, _HALO - len(tail):_HALO] = tail
            ext[0, _HALO:_HALO + len(seg)] = seg
            nv = torch.tensor([len(seg)], dtype=torch.int32, device=self.device)
            wl, ws = candidate_words(torch.from_numpy(ext).to(self.device), nv,
                                     params.mask_s, params.mask_l)
            p, s = _decode_words(wl[0].cpu().numpy().view(np.uint32),
                                 ws[0].cpu().numpy().view(np.uint32), offset)
            all_pos.append(p)
            all_s.append(s)
            tail = np.concatenate([tail, seg])[-_HALO:]
            offset += len(seg)
        if all_pos:
            pos_l = np.concatenate(all_pos)
            is_s = np.concatenate(all_s)
        else:
            pos_l = np.empty(0, dtype=np.int64)
            is_s = np.empty(0, dtype=bool)
        return pos_l[is_s], pos_l

    def chunk_stream(self, data):
        """Chunk one stream; list of (offset, length), bit-identical to
        :func:`.cdc_cpu.chunk_stream`."""
        pos_s, pos_l = self.candidate_positions(data)
        return cuts_to_chunks(select_cuts(pos_s, pos_l, len(data), self.params))


# ---------------------------------------------------------------------------
# Batched scan + on-device cut selection
# ---------------------------------------------------------------------------


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-row gather: ``a`` (B, N), ``idx`` (B, K) in range -> (B, K)."""
    return torch.gather(a, 1, idx)


def _nonzero_static(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Per row, the first ``size`` indices where ``mask`` (B, N) is true,
    padded with ``fill``: ``jnp.nonzero(size=, fill_value=)`` without a
    host sync.  A cumsum ranks the true lanes; a scatter places each at its
    rank, and lanes ranked past ``size`` land in one sentinel slot that is
    sliced off (its racing writes are never read)."""
    B, N = mask.shape
    rank = torch.cumsum(mask, dim=1) - 1
    dest = torch.where(mask & (rank < size), rank, size)
    out = torch.full((B, size + 1), fill, dtype=torch.int64, device=mask.device)
    src = torch.arange(N, dtype=torch.int64, device=mask.device).expand(B, N)
    out.scatter_(1, dest, src)
    return out[:, :size]


def _block_cum(pos: torch.Tensor, padded: int, bb: int) -> torch.Tensor:
    """Exclusive prefix counts of candidates per ``2^bb``-byte block: row
    ``b`` of the result at block ``k`` counts valid candidates (``pos <
    padded``) below ``k << bb``.  (B, cap) -> (B, (padded >> bb) + 2)."""
    B = pos.shape[0]
    nb = (padded >> bb) + 2
    slot = torch.where(pos < padded, pos >> bb, nb)
    cnt = torch.zeros(B, nb + 1, dtype=torch.int64, device=pos.device)
    cnt.scatter_add_(1, slot, torch.ones_like(slot))
    cnt = cnt[:, :nb]
    zero = torch.zeros(B, 1, dtype=torch.int64, device=pos.device)
    return torch.cat([zero, torch.cumsum(cnt, dim=1)[:, :-1]], dim=1)


def _make_lookup(pos, cum, cap: int, padded: int, bb: int, probes: int = 6):
    """searchsorted-left on each row's sorted candidates: the block prefix
    table gives a lower bound, ``probes`` parallel probes correct it.  More
    than ``probes`` candidates in one block sets ``over``, which flags the
    row (the JAX package's semantics, kept so the packed rows agree)."""
    nb1 = cum.shape[1] - 1

    def lookup(q):
        qc = q.clamp(0, padded)
        idx0 = _take(cum, (qc >> bb).clamp(max=nb1))
        adv = torch.zeros_like(idx0)
        over = None
        for k in range(probes + 1):
            i = idx0 + k
            below = (i < cap) & (_take(pos, i.clamp(max=cap - 1)) < qc)
            if k < probes:
                adv = adv + below.to(torch.int64)
            else:
                over = below
        return idx0 + adv, over

    return lookup


def _parallel_select(pos_l, pos_s, n, *, min_size: int, desired_size: int,
                     max_size: int, s_cap: int, l_cap: int, cut_cap: int,
                     padded: int, block_bits: int, probe_iters: int = 6):
    """FastCDC cut selection by pointer jumping, per row of a batch.

    ``pos_l`` (B, l_cap) / ``pos_s`` (B, s_cap) sorted candidate positions
    padded with ``padded``; ``n`` (B,) stream lengths.  As in the JAX
    package: F(c), the next cut after a chunk ending at candidate ``c``
    (with closed-form jumps over forced max-size runs), for every candidate
    at once; doubling tables of F; then each output slot walks the tables.
    Returns ``(n_cuts (B,), cuts (B, cut_cap), unresolved (B,) bool)``.
    """
    m, d, M = min_size, desired_size, max_size
    TERM = l_cap
    B = pos_l.shape[0]
    dev = pos_l.device
    n1 = n.to(torch.int64)[:, None]

    look_ovf = []
    look_s = _make_lookup(pos_s, _block_cum(pos_s, padded, block_bits),
                          s_cap, padded, block_bits)
    look_l = _make_lookup(pos_l, _block_cum(pos_l, padded, block_bits),
                          l_cap, padded, block_bits)

    def ss_s(q, use=None):
        i, ov = look_s(q)
        look_ovf.append((ov if use is None else ov & use).any(dim=1))
        return i

    def ss_l(q, use=None):
        i, ov = look_l(q)
        look_ovf.append((ov if use is None else ov & use).any(dim=1))
        return i

    def step_from(x, use=None):
        """Candidate-window check for starts ``x``: (hit, cut position)."""
        hi1 = torch.minimum(x + (d - 2), n1 - 2)
        i = ss_s(x + (m - 1), use)
        e1 = _take(pos_s, i.clamp(max=s_cap - 1))
        ok1 = (i < s_cap) & (e1 <= hi1)
        hi2 = torch.minimum(x + (M - 2), n1 - 2)
        j = ss_l(x + (d - 1), use)
        e2 = _take(pos_l, j.clamp(max=l_cap - 1))
        ok2 = (j < l_cap) & (e2 <= hi2)
        return ok1 | ok2, torch.where(ok1, e1, e2)

    def resolve(x0):
        """F for starts ``x0``: (terminal, forced count, final cut,
        unresolved)."""
        y = x0
        jcnt = torch.zeros_like(x0)
        done = torch.zeros_like(x0, dtype=torch.bool)
        is_term = torch.zeros_like(done)
        final = torch.full_like(x0, -1)
        for _ in range(probe_iters):
            short = (n1 - y) <= m  # short tail -> single final chunk
            hit, e = step_from(y, use=~done & ~short)
            at_eof = y >= n1 - M  # forced cut would land at n-1
            now_term = short | (~hit & at_eof)
            resolved = ~done & (short | hit | at_eof)
            final = torch.where(
                resolved,
                torch.where(short, n1 - 1, torch.where(hit, e, n1 - 1)),
                final)
            is_term = torch.where(resolved, now_term, is_term)
            done = done | resolved
            # jump the candidate-free gap to the earliest start that could
            # see the next strict/loose candidate in its window
            qs = _take(pos_s, ss_s(y + (m - 1), ~done).clamp(max=s_cap - 1))
            ql = _take(pos_l, ss_l(y + (d - 1), ~done).clamp(max=l_cap - 1))
            target = torch.minimum(torch.minimum(qs - (d - 2), ql - (M - 2)),
                                   n1 - M)
            steps = torch.div(target - y + M - 1, M,
                              rounding_mode="floor").clamp(min=1)
            y = torch.where(done, y, y + steps * M)
            jcnt = torch.where(done, jcnt, jcnt + steps)
        return is_term, jcnt, final, ~done

    # F for every candidate node (start = pos_l[c] + 1) and for START
    zero_col = torch.zeros(B, 1, dtype=torch.int64, device=dev)
    starts = torch.cat([pos_l + 1, zero_col], dim=1)
    is_term, jcnt, final, unres = resolve(starts)
    node_final = final[:, :l_cap]
    node_term = is_term[:, :l_cap]
    node_un = unres[:, :l_cap]
    nxt0 = torch.where(node_term, TERM,
                       ss_l(node_final, ~node_term & ~node_un))
    emit0 = jcnt[:, :l_cap] + 1  # forced cuts + 1 candidate/terminal cut
    # TERM self-loop emits nothing
    nxt0 = torch.cat([nxt0, zero_col + TERM], dim=1)
    emit0 = torch.cat([emit0, zero_col], dim=1)
    un0 = torch.cat([node_un, zero_col.bool()], dim=1)

    # 2^(levels-1) hops must cover the longest possible chain (cut_cap)
    levels = max(1, cut_cap.bit_length() + 1)
    nxts, emits, uns = [nxt0], [emit0], [un0]
    for _ in range(levels - 1):
        nk, ek, uk = nxts[-1], emits[-1], uns[-1]
        nxts.append(_take(nk, nk))
        emits.append(ek + _take(ek, nk))
        uns.append(uk | _take(uk, nk))

    # hop 0: from START (virtual cut at -1, start 0)
    h0_term = is_term[:, l_cap:]
    h0_j = jcnt[:, l_cap:]
    h0_final = final[:, l_cap:]
    h0_un = unres[:, l_cap:]
    b1 = torch.where(h0_term, TERM, ss_l(h0_final, ~h0_term & ~h0_un))
    h0_emit = h0_j + 1
    total = h0_emit + _take(emits[-1], b1)
    row_unres = h0_un[:, 0] | _take(uns[-1], b1)[:, 0]
    for ov in look_ovf:
        row_unres = row_unres | ov
    n_cuts = torch.where(n1 > 0, total, 0)  # (B, 1)

    # per-slot table walk
    mslot = torch.arange(cut_cap, dtype=torch.int64, device=dev)[None, :]
    in_h0 = mslot < h0_emit
    cut_h0 = torch.where(mslot < h0_j, (mslot + 1) * M - 1, h0_final)
    mrel = mslot - h0_emit
    cur = b1.expand(B, cut_cap).contiguous()
    acc = torch.zeros(B, cut_cap, dtype=torch.int64, device=dev)
    for k in range(levels - 1, -1, -1):
        cand_acc = acc + _take(emits[k], cur)
        step = cand_acc <= mrel
        cur = torch.where(step, _take(nxts[k], cur), cur)
        acc = torch.where(step, cand_acc, acc)
    # the hop from `cur` covers slot mrel: the r-th of its forced cuts, or
    # its final candidate/terminal cut
    r = mrel - acc
    cur_safe = cur.clamp(max=TERM)
    node = cur_safe.clamp(max=l_cap - 1)
    x_cur = _take(pos_l, node) + 1
    fcount = (_take(emit0, cur_safe) - 1).clamp(min=0)
    cut_m = torch.where(r < fcount, x_cur + (r + 1) * M - 1,
                        _take(node_final, node))
    cuts = torch.where(in_h0, cut_h0, cut_m)
    cuts = torch.where(mslot < n_cuts, cuts, -1)
    return n_cuts[:, 0], cuts, row_unres


def _compact_words(words_l, words_s, *, P: int, l_cap: int, s_cap: int):
    """Fixed-capacity sorted (pos_l, pos_s) from packed candidate words by
    the JAX package's three-level compaction (128-word blocks, words,
    bits), plus the per-row capacity overflow flag.  Positions past the
    candidates are padded with ``P``."""
    B, n_words = words_l.shape
    dev = words_l.device
    w_cap = max(512, min(l_cap, P // 32 if P >= 32 else 1))
    blk = 128
    while blk > 1 and n_words % blk:
        blk //= 2
    nblk = n_words // blk
    b_cap = min(nblk, max(512, w_cap // 4))

    wl2 = words_l.reshape(B, nblk, blk)
    ws2 = words_s.reshape(B, nblk, blk)
    any_b = (wl2 != 0).any(dim=2)
    bidx = _nonzero_static(any_b, b_cap, nblk)
    bsafe = bidx.clamp(0, nblk - 1)[:, :, None].expand(B, b_cap, blk)
    in_b = (bidx < nblk)[:, :, None]
    sub_l = torch.where(in_b, torch.gather(wl2, 1, bsafe), 0).reshape(B, -1)
    sub_s = torch.where(in_b, torch.gather(ws2, 1, bsafe), 0).reshape(B, -1)
    lane_b = torch.arange(blk, dtype=torch.int64, device=dev)
    sub_widx = (bidx[:, :, None] * blk + lane_b).reshape(B, -1)
    nzw = sub_l != 0
    sub_n = sub_l.shape[1]
    wsel = _nonzero_static(nzw, w_cap, sub_n)
    wsafe = wsel.clamp(0, sub_n - 1)
    in_range = wsel < sub_n
    bits_l = torch.where(in_range, _take(sub_l, wsafe), 0).to(torch.int64)
    bits_s = torch.where(in_range, _take(sub_s, wsafe), 0).to(torch.int64)
    widx = torch.where(in_range, _take(sub_widx, wsafe), n_words)
    lane = torch.arange(32, dtype=torch.int64, device=dev)
    # bits of the int32 words: bit 31 comes out of the sign, & 1 keeps it
    flat_l = ((bits_l[:, :, None] >> lane) & 1).bool().reshape(B, -1)
    flat_s = ((bits_s[:, :, None] >> lane) & 1).bool().reshape(B, -1)
    flat_pos = (widx[:, :, None] * 32 + lane).reshape(B, -1)
    flat_n = flat_pos.shape[1]
    sel = _nonzero_static(flat_l, l_cap, flat_n)
    sel_ok = sel < flat_n
    sel_safe = sel.clamp(0, flat_n - 1)
    pos_l = torch.where(sel_ok, _take(flat_pos, sel_safe), P)
    is_s = sel_ok & _take(flat_s, sel_safe)
    ssel = _nonzero_static(is_s, s_cap, l_cap)
    pos_s = torch.where(ssel < l_cap, _take(pos_l, ssel.clamp(0, l_cap - 1)), P)
    overflow = ((any_b.sum(dim=1) > b_cap) | (nzw.sum(dim=1) > w_cap)
                | (flat_l.sum(dim=1) > l_cap) | (is_s.sum(dim=1) > s_cap))
    return pos_l, pos_s, overflow


def scan_select_batch(ext_b: torch.Tensor, nv_b: torch.Tensor, *,
                      min_size: int, desired_size: int, max_size: int,
                      mask_s: int, mask_l: int, s_cap: int, l_cap: int,
                      cut_cap: int) -> torch.Tensor:
    """Candidate scan + FastCDC cut selection of a resident batch.

    ``ext_b`` (B, _HALO+P) u8 rows (31 halo bytes, then the stream, zero
    padded), ``nv_b`` (B,) int32 valid lengths -> (B, 2+cut_cap) int32
    rows ``[overflow, n_cuts, inclusive chunk ends..., -1 padded]``,
    bit-identical to the JAX ``scan_select_batch``.  ``overflow`` flags a
    row whose candidates exceeded the capacities (adversarial data); its
    cut list must be redone by the oracle.
    """
    from .scan_fused import candidate_words

    P = ext_b.shape[1] - _HALO
    wl_b, ws_b = candidate_words(ext_b, nv_b, mask_s, mask_l)
    pos_l, pos_s, ovf = _compact_words(wl_b, ws_b, P=P, l_cap=l_cap,
                                       s_cap=s_cap)
    # lookup-block size keeps the expected loose candidates per block
    # <= 1/8, so the 6-probe correction never overflows on typical data
    mask_l_bits = bin(mask_l).count("1")
    block_bits = max(5, min(11, mask_l_bits - 3))
    n_cuts, cuts, unres = _parallel_select(
        pos_l, pos_s, nv_b, min_size=min_size, desired_size=desired_size,
        max_size=max_size, s_cap=s_cap, l_cap=l_cap, cut_cap=cut_cap,
        padded=P, block_bits=block_bits)
    overflow = (ovf | unres).to(torch.int64)
    return torch.cat([overflow[:, None], n_cuts[:, None], cuts],
                     dim=1).to(torch.int32)
