"""Deterministic GEAR table + CDC parameter set (see CDC_SPEC.md).

The port's own copy of ``backuwup_tpu/ops/gear.py`` (the port imports
nothing of the JAX package); the two must stay equal, which
``carry.gear_table_matches`` and the tests check.

The gear function is **computable, not just tabulated**: ``GEAR[b] =
fmix32(GEAR_SEED32 + b)`` where ``fmix32`` is the murmur3 32-bit
finalizer.  Hosts (CPU oracle, native C baseline) precompute the 256-entry
table once; the device scan (``csrc/scan_candidates.cu``) computes the
formula once per staged byte.  Spec v2; v1 was SplitMix64-seeded
(changing the table re-chunks streams, so v1 and v2 snapshots do not
dedup against each other).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import defaults

_M32 = 0xFFFFFFFF
GEAR_SEED32 = 0x6261636B  # "back"
GEAR_WINDOW = 32  # bytes of influence of the 32-bit rolling hash


def fmix32(h: int) -> int:
    """murmur3 finalizer: full-avalanche bijection on u32."""
    h &= _M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


def make_gear_table() -> np.ndarray:
    """256 x uint32: ``fmix32(GEAR_SEED32 + b)`` for b in 0..255."""
    return np.array([fmix32(GEAR_SEED32 + b) for b in range(256)],
                    dtype=np.uint32)


GEAR = make_gear_table()


def _top_bits_mask(bits: int) -> int:
    if not 0 < bits < 32:
        raise ValueError("mask bits must be in (0, 32)")
    return (0xFFFFFFFF << (32 - bits)) & 0xFFFFFFFF


@dataclass(frozen=True)
class CDCParams:
    """Chunking parameters; defaults mirror client/src/defaults.rs:62-68."""

    min_size: int = defaults.CDC_MIN_CHUNK
    desired_size: int = defaults.CDC_DESIRED_CHUNK
    max_size: int = defaults.CDC_MAX_CHUNK
    mask_s_bits: int = defaults.CDC_MASK_S_BITS
    mask_l_bits: int = defaults.CDC_MASK_L_BITS

    def __post_init__(self) -> None:
        if not (0 < self.min_size <= self.desired_size <= self.max_size):
            raise ValueError("require 0 < min <= desired <= max")
        if self.mask_l_bits >= self.mask_s_bits:
            raise ValueError("mask_l must be looser (fewer bits) than mask_s")

    @property
    def mask_s(self) -> int:
        return _top_bits_mask(self.mask_s_bits)

    @property
    def mask_l(self) -> int:
        return _top_bits_mask(self.mask_l_bits)

    @classmethod
    def from_desired(cls, desired: int) -> "CDCParams":
        if desired & (desired - 1):
            raise ValueError("desired size must be a power of two")
        bits = desired.bit_length() - 1
        return cls(min_size=max(64, desired // 4), desired_size=desired,
                   max_size=3 * desired, mask_s_bits=bits + 2,
                   mask_l_bits=bits - 2)
