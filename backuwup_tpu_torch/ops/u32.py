"""u32 arithmetic for the plain PyTorch versions.

PyTorch has no ``+``, ``<<`` or ``>>`` for ``uint32`` on the CPU, so the
plain versions hold u32 values in ``int64`` masked to ``0xFFFFFFFF``:
sums and shifts stay exact in 64 bits and are masked back, and the two
``fmix32`` multiplies go through 16-bit halves so no product leaves
int64's range.  Kernel inputs and every public output carry the same 32
bits in ``int32`` tensors (the CUDA kernels read and write them as u32),
so ``numpy.view(np.uint32)`` of a public output equals the JAX package's
u32 array.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def from_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 (or uint8/int64) bits -> int64 holding the u32 value."""
    return x.to(torch.int64) & M32


def to_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 with the same 32 bits."""
    x = x & M32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def mul_const(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for u32 ``x`` (int64) and a u32 constant."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & M32
