"""Batched BLAKE3 on the device: the leaf-scan kernel and the tree.

Port of ``backuwup_tpu/ops/blake3_tpu.py``.  Inputs are padded to ``L``
1 KiB leaves; each leaf's 16-block compression chain runs in the CUDA
kernel ``csrc/blake3_leaf.cu`` (replacing the Pallas
``_leaf_scan_kernel``; its header gives the bound on an H100 and the
design), and the binary tree of chaining values is pair-merged level by
level with plain PyTorch ops, an unpaired rightmost node riding up
unchanged, which reproduces BLAKE3's largest-power-of-two-left split.
Masking mirrors the JAX package line for line, so digests are
bit-identical to the spec oracle (:mod:`.blake3_cpu`) for every length.

u32 words are ``int64`` masked to 32 bits inside the plain ops and
``int32`` bits at the kernel and at every public output (see
:mod:`.u32`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import defaults
from ..utils.device import resolve_device
from .blake3_cpu import (
    BLOCK_LEN,
    CHUNK_END,
    CHUNK_LEN,
    CHUNK_START,
    G_SCHEDULE,
    IV,
    MAX_LEAVES_PER_CHUNK,
    MSG_PERMUTATION,
    PARENT,
    ROOT,
)
from .u32 import M32, from_bits, rotr, to_bits


def _g4(a, b, c, d, mx, my):
    """Four BLAKE3 G functions at once: rows of (4, N) state blocks."""
    a = (a + b + mx) & M32
    d = rotr(d ^ a, 16)
    c = (c + d) & M32
    b = rotr(b ^ c, 12)
    a = (a + b + my) & M32
    d = rotr(d ^ a, 8)
    c = (c + d) & M32
    b = rotr(b ^ c, 7)
    return a, b, c, d


# the column step of G_SCHEDULE is rows (i, 4+i, 8+i, 12+i); the diagonal
# step is the same after rotating rows b, c, d left by 1, 2, 3
assert G_SCHEDULE[:4] == tuple((i, 4 + i, 8 + i, 12 + i) for i in range(4))
assert G_SCHEDULE[4:] == tuple((i, 4 + (i + 1) % 4, 8 + (i + 2) % 4,
                                12 + (i + 3) % 4) for i in range(4))
_PERM = torch.tensor(MSG_PERMUTATION, dtype=torch.int64)


def _compress_cols(cv, m, counter_lo, counter_hi, block_len, flags):
    """One BLAKE3 compression over lanes: ``cv`` 8 and ``m`` 16 int64
    columns, the rest int64 columns of the same lane shape.  Returns the 8
    output chaining-value columns.  The four G of a step run as one op on
    (4, N) row blocks, which keeps the count of tensor ops (and of device
    launches) per compression low."""
    a = torch.stack(list(cv[:4]))
    b = torch.stack(list(cv[4:]))
    c = torch.stack([torch.full_like(counter_lo, IV[i]) for i in range(4)])
    d = torch.stack([counter_lo, counter_hi, block_len, flags])
    m = torch.stack(list(m))
    perm = _PERM.to(m.device)
    for r in range(7):
        a, b, c, d = _g4(a, b, c, d, m[0:8:2], m[1:8:2])
        b, c, d = b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0)
        a, b, c, d = _g4(a, b, c, d, m[8:16:2], m[9:16:2])
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(3, 0)
        if r < 6:
            m = m[perm]
    return list((a ^ c).unbind(0)) + list((b ^ d).unbind(0))


def _bytes_to_words(buf: torch.Tensor) -> torch.Tensor:
    """``(..., 4k)`` u8 -> ``(..., k)`` int32 little-endian words (a view
    of contiguous ``buf``)."""
    return buf.contiguous().view(torch.int32)


def _check_leaf_inputs(words, nb, lbl, counter) -> int:
    if words.dtype != torch.int32 or words.dim() != 2 or words.shape[1] != 256:
        raise TypeError("words must be a (lanes, 256) int32 tensor")
    lanes = words.shape[0]
    for name, t in (("nb", nb), ("lbl", lbl), ("counter", counter)):
        if t.dtype != torch.int32 or t.shape != (lanes,):
            raise TypeError(f"{name} must be a (lanes,) int32 tensor")
        if t.device != words.device:
            raise ValueError("leaf-scan inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    return lanes


def leaf_scan_plain(words: torch.Tensor, nb: torch.Tensor, lbl: torch.Tensor,
                    counter: torch.Tensor):
    """Plain PyTorch version of the leaf kernel (the counterpart of the
    JAX ``_leaf_scan_xla_flat``): (lanes, 8) leaf CVs and penultimate CVs,
    int32 bits."""
    lanes = _check_leaf_inputs(words, nb, lbl, counter)
    w = from_bits(words).reshape(lanes, MAX_LEAVES_PER_CHUNK, 16)
    nb = nb.to(torch.int64)
    lbl = from_bits(lbl)
    counter = from_bits(counter)
    zeros = torch.zeros_like(counter)
    cv = [torch.full_like(counter, IV[i]) for i in range(8)]
    cv_pre = list(cv)
    for blk in range(MAX_LEAVES_PER_CHUNK):
        m = [w[:, blk, j] for j in range(16)]
        active = blk < nb
        is_last = blk == nb - 1
        start = CHUNK_START if blk == 0 else 0
        flags = torch.where(is_last, start | CHUNK_END, start)
        blen = torch.where(is_last, lbl, BLOCK_LEN)
        cv_pre = [torch.where(is_last, c, p) for c, p in zip(cv, cv_pre)]
        out = _compress_cols(cv, m, counter, zeros, blen, flags)
        cv = [torch.where(active, o, c) for o, c in zip(out, cv)]
    return to_bits(torch.stack(cv, dim=1)), to_bits(torch.stack(cv_pre, dim=1))


def leaf_scan(words: torch.Tensor, nb: torch.Tensor, lbl: torch.Tensor,
              counter: torch.Tensor):
    """``(lanes, 256)`` int32 leaf words, per-lane block count, last-block
    length and chunk counter -> ``(cv, cvp)``, each ``(lanes, 8)`` int32.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`leaf_scan_plain`."""
    lanes = _check_leaf_inputs(words, nb, lbl, counter)
    if words.device.type == "cpu":
        return leaf_scan_plain(words, nb, lbl, counter)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    if words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned for the kernel")
    from .. import kernels

    lib = kernels.library("blake3_leaf")
    cv = torch.empty((lanes, 8), dtype=torch.int32, device=words.device)
    cvp = torch.empty_like(cv)
    if lanes == 0:
        return cv, cvp
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bkw_blake3_leaf(words.data_ptr(), nb.data_ptr(),
                                 lbl.data_ptr(), counter.data_ptr(),
                                 cv.data_ptr(), cvp.data_ptr(), lanes, stream)
    kernels.check_launch(rc, "blake3_leaf")
    leaf_scan.launches += 1
    return cv, cvp


leaf_scan.launches = 0


def _ceil_div(a: torch.Tensor, b: int) -> torch.Tensor:
    return -torch.div(-a, b, rounding_mode="floor")


def root_single(cvp: torch.Tensor, words: torch.Tensor, nb: torch.Tensor,
                lbl: torch.Tensor) -> torch.Tensor:
    """Single-leaf roots: recompress each leaf's last block with ROOT from
    its penultimate CV.  ``cvp`` (N, 8) int32, ``words`` (N, 256) int32,
    ``nb``/``lbl`` (N,) int64 -> list of 8 (N,) int64 columns."""
    n = words.shape[0]
    blocks = from_bits(words).reshape(n, MAX_LEAVES_PER_CHUNK, 16)
    last = (nb - 1).clamp(min=0)[:, None, None].expand(n, 1, 16)
    m0 = torch.gather(blocks, 1, last)[:, 0]
    flags0 = torch.where(nb == 1, CHUNK_START, 0) | (CHUNK_END | ROOT)
    zeros = torch.zeros(n, dtype=torch.int64, device=words.device)
    cvp = from_bits(cvp)
    return _compress_cols([cvp[:, i] for i in range(8)],
                          [m0[:, w] for w in range(16)], zeros, zeros,
                          lbl, flags0)


def digest_padded(buf: torch.Tensor, lens: torch.Tensor, *,
                  L: int) -> torch.Tensor:
    """Digest a zero-padded batch: ``buf`` (B, L*1024) u8, ``lens`` (B,)
    true byte lengths -> (B, 8) int32 root chaining values (the
    little-endian digest words).  Bytes past each length are ignored."""
    B = buf.shape[0]
    dev = buf.device
    lens = lens.to(torch.int64)
    pos = torch.arange(L * CHUNK_LEN, dtype=torch.int64, device=dev)
    buf = torch.where(pos[None, :] < lens[:, None], buf, 0).to(torch.uint8)
    words = _bytes_to_words(buf).reshape(B * L, 256)
    n_chunks = _ceil_div(lens, CHUNK_LEN).clamp(min=1)
    chunk_idx = torch.arange(L, dtype=torch.int64, device=dev)
    chunk_bytes = (lens[:, None] - chunk_idx[None, :] * CHUNK_LEN).clamp(
        0, CHUNK_LEN)
    n_blocks = _ceil_div(chunk_bytes, BLOCK_LEN).clamp(min=1)
    last_block_len = chunk_bytes - (n_blocks - 1) * BLOCK_LEN
    counter = chunk_idx[None, :].expand(B, L).reshape(-1)
    cv_mat, cvp_mat = leaf_scan(words, n_blocks.reshape(-1).to(torch.int32),
                                last_block_len.reshape(-1).to(torch.int32),
                                counter.to(torch.int32).contiguous())
    cvs = from_bits(cv_mat).reshape(B, L, 8)
    leaf_cv = [cvs[:, :, i] for i in range(8)]
    lane0 = torch.arange(B, dtype=torch.int64, device=dev) * L
    rs = root_single(cvp_mat[lane0], words[lane0], n_blocks[:, 0],
                     last_block_len[:, 0])
    is_single = n_chunks == 1
    root_cv = [torch.where(is_single, r, 0) for r in rs]
    return to_bits(tree_reduce_cvs(leaf_cv, n_chunks, root_cv))


def tree_reduce_cvs(leaf_cv, counts, root_cv) -> torch.Tensor:
    """BLAKE3 tree reduction over per-input leaf chaining values.

    ``leaf_cv``: 8 (B, L) int64 columns; ``counts``: (B,) true leaf counts
    (>= 1); ``root_cv``: 8 (B,) columns pre-seeded with the single-leaf
    roots (used where counts == 1).  Returns (B, 8) int64.
    """
    B = leaf_cv[0].shape[0]
    dev = leaf_cv[0].device
    cvs = leaf_cv
    counts = counts.to(torch.int64)
    cur = leaf_cv[0].shape[1]
    while cur > 1:
        Pn = cur // 2
        left = [c[:, 0:2 * Pn:2] for c in cvs]
        right = [c[:, 1:2 * Pn:2] for c in cvs]
        m = [x.reshape(-1) for x in left] + [x.reshape(-1) for x in right]
        zero = torch.zeros(B * Pn, dtype=torch.int64, device=dev)
        ivc = [torch.full_like(zero, IV[i]) for i in range(8)]
        # the root merge (count 2 -> 1) always happens at pair 0: it takes
        # ROOT there, in the same compression as every other pair.  Its
        # parent CV is then wrong, but a count-1 input never merges again
        pair_idx = torch.arange(Pn, dtype=torch.int64, device=dev)
        is_root_merge = counts == 2
        root_pair = (pair_idx[None, :] == 0) & is_root_merge[:, None]
        flags = torch.where(root_pair, PARENT | ROOT, PARENT).reshape(-1)
        merged = _compress_cols(ivc, m, zero, zero, zero + BLOCK_LEN, flags)
        merged = [x.reshape(B, Pn) for x in merged]
        pair_merges = (2 * pair_idx[None, :] + 1) < counts[:, None]
        nxt = []
        for ci in range(8):
            col = torch.where(pair_merges, merged[ci], left[ci])
            if cur % 2:
                col = torch.cat([col, cvs[ci][:, -1:]], dim=1)
            nxt.append(col)
        root_cv = [torch.where(is_root_merge, mr[:, 0], rc)
                   for mr, rc in zip(merged, root_cv)]
        cvs = nxt
        counts = torch.where(counts > 1, (counts + 1) // 2, counts)
        cur = (cur + 1) // 2
    return torch.stack(root_cv, dim=1)


def digests_to_bytes(root: torch.Tensor) -> np.ndarray:
    """(N, 8) int32 root CVs (any device) -> (N, 32) u8 digests."""
    return np.ascontiguousarray(root.cpu().numpy()).view(np.uint8).reshape(-1, 32)


def _leaf_bucket(n_bytes: int) -> int:
    """Smallest configured leaf bucket holding ``n_bytes``."""
    n_chunks = max(1, -(-n_bytes // CHUNK_LEN))
    for b in defaults.BLAKE3_LEAF_BUCKETS:
        if n_chunks <= b:
            return b
    return n_chunks


def bucketed_batches(datas):
    """Group inputs by leaf bucket; yields (indices, buf, lens, L), numpy."""
    groups = {}
    for i, d in enumerate(datas):
        groups.setdefault(_leaf_bucket(len(d)), []).append(i)
    for L, idxs in sorted(groups.items()):
        buf = np.zeros((len(idxs), L * CHUNK_LEN), dtype=np.uint8)
        lens = np.zeros(len(idxs), dtype=np.int32)
        for row, i in enumerate(idxs):
            d = datas[i]
            buf[row, :len(d)] = np.frombuffer(bytes(d), dtype=np.uint8)
            lens[row] = len(d)
        yield idxs, buf, lens, L


def blake3_many_gpu(datas, device=None) -> list:
    """Batched digests on the device; bit-exact vs
    :func:`.blake3_cpu.blake3_hash`."""
    dev = resolve_device(device)
    datas = list(datas)
    out = [None] * len(datas)
    for idxs, buf, lens, L in bucketed_batches(datas):
        root = digest_padded(torch.from_numpy(buf).to(dev),
                             torch.from_numpy(lens).to(dev), L=L)
        dig = digests_to_bytes(root)
        for row, i in enumerate(idxs):
            out[i] = dig[row].tobytes()
    return out
