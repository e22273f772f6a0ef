"""Gear values and flat-ladder candidates: two CUDA kernels and their
plain versions.

Counterpart of ``backuwup_tpu/ops/pallas_kernels.py``, whose two Pallas
kernels are entry points of their own there (not wired into the JAX
pipeline).  Same contracts:

* :func:`gear_values` -- ``GEAR[b]`` per byte, any length; u8 ``(n,)``
  -> int32 ``(n,)`` carrying the u32 bits.  Kernel ``csrc/gear_values.cu``
  (replaces ``gear_values_pallas`` -> ``_gear_kernel``).
* :func:`ladder_candidates` -- flat gear values (int32 u32 bits, length a
  multiple of ``LADDER_BLOCK``) -> ``(cand_l, cand_s)`` u8 0/1 vectors:
  ``cand_l[p] = ((h[p] & mask_l) == 0) & (p < n_valid)``, ``cand_s[p] =
  cand_l[p] & ((h[p] & mask_s) == 0)``, with ``h[p] = sum_{k<32} g[p-k]
  << k (mod 2^32)`` and ``g[<0] = 0``.  Kernel
  ``csrc/ladder_candidates.cu`` (replaces ``ladder_candidates_pallas`` ->
  ``_make_ladder_cand_kernel``).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version.  There is no other path.
"""

from __future__ import annotations

import torch

from .cdc_gpu import _gear_values
from .u32 import M32, from_bits, to_bits

_LANES = 128
_LADDER_ROWS = 512
# positions per Pallas grid program; the length contract of the ladder
LADDER_BLOCK = _LADDER_ROWS * _LANES


def _check_bytes(b: torch.Tensor) -> None:
    if b.dtype != torch.uint8 or b.dim() != 1:
        raise TypeError("b must be a 1-D uint8 tensor")


def _check_ladder(g: torch.Tensor) -> None:
    if g.dtype != torch.int32 or g.dim() != 1:
        raise TypeError("g must be a 1-D int32 tensor of u32 gear values")
    if g.shape[0] % LADDER_BLOCK:
        raise ValueError(
            f"caller pads to the ladder block size ({LADDER_BLOCK})")


def gear_values_plain(b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``fmix32(GEAR_SEED32 + b)`` per byte."""
    _check_bytes(b)
    return to_bits(_gear_values(b))


def gear_values(b: torch.Tensor) -> torch.Tensor:
    """``GEAR[b]`` for a u8 vector of any length; int32 u32 bits."""
    _check_bytes(b)
    if b.device.type == "cpu":
        return gear_values_plain(b)
    if b.device.type != "cuda":
        raise ValueError(f"unsupported device {b.device}")
    from .. import kernels

    b = b.contiguous()
    out = torch.empty(b.shape, dtype=torch.int32, device=b.device)
    if b.numel() == 0:
        return out
    lib = kernels.library("gear_values")
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bkw_gear_values(b.data_ptr(), out.data_ptr(), b.numel(),
                                 stream)
    kernels.check_launch(rc, "gear_values")
    gear_values.launches += 1
    return out


gear_values.launches = 0


def ladder_candidates_plain(g: torch.Tensor, n_valid: int, *, mask_s: int,
                            mask_l: int):
    """Plain PyTorch version: five doubling passes of the 32-tap windowed
    sum over the flat vector (taps before position 0 read zero)."""
    _check_ladder(g)
    a = from_bits(g)
    for t in range(5):
        s = 1 << t
        shifted = torch.cat([a.new_zeros(s), a[:-s]])
        a = (a + (shifted << s)) & M32
    pos = torch.arange(a.shape[0], dtype=torch.int64, device=g.device)
    cand_l = ((a & (mask_l & M32)) == 0) & (pos < int(n_valid))
    cand_s = cand_l & ((a & (mask_s & M32)) == 0)
    return cand_l.to(torch.uint8), cand_s.to(torch.uint8)


def ladder_candidates(g: torch.Tensor, n_valid: int, *, mask_s: int,
                      mask_l: int):
    """Flat u32 gear values ``(n,)`` (``n % LADDER_BLOCK == 0``) ->
    ``(cand_l, cand_s)``, each ``(n,)`` u8 0/1."""
    _check_ladder(g)
    if g.device.type == "cpu":
        return ladder_candidates_plain(g, n_valid, mask_s=mask_s,
                                       mask_l=mask_l)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    from .. import kernels

    g = g.contiguous()
    n = g.shape[0]
    cl = torch.empty(n, dtype=torch.uint8, device=g.device)
    cs = torch.empty_like(cl)
    if n == 0:
        return cl, cs
    lib = kernels.library("ladder_candidates")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bkw_ladder_candidates(
            g.data_ptr(), cl.data_ptr(), cs.data_ptr(), n, int(n_valid),
            mask_s & M32, mask_l & M32, stream)
    kernels.check_launch(rc, "ladder_candidates")
    ladder_candidates.launches += 1
    return cl, cs


ladder_candidates.launches = 0
