"""CDC candidate words: the CUDA scan kernel and its plain version.

``candidate_words`` replaces the JAX package's fused Pallas scan
(``backuwup_tpu/ops/scan_fused.py`` v1 ``_fused_candidate_words_v1`` and
v2 ``_fused_candidate_words_u32``) with one hand-written CUDA kernel,
``csrc/scan_candidates.cu`` (its header gives the bound on an H100 and
the design).  The output contract is the same: position-major packed
u32 candidate words, bit-identical to ``_pack_bits`` of the hash ladder.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs :func:`candidate_words_plain`.  There is no other path.
"""

from __future__ import annotations

import torch

from .cdc_gpu import _HALO, _candidate_words, _hash_ext_fast

# byte and position offsets inside the kernel stay below 2^31 at the
# 128 MiB dispatch budget of ops/pipeline.py
_MAX_BATCH_BYTES = (1 << 31) - 1


def _check(ext_b: torch.Tensor, nv_b: torch.Tensor) -> int:
    if ext_b.dtype != torch.uint8 or ext_b.dim() != 2:
        raise TypeError("ext_b must be a (B, 31+P) uint8 tensor")
    if nv_b.dtype != torch.int32 or nv_b.shape != (ext_b.shape[0],):
        raise TypeError("nv_b must be a (B,) int32 tensor")
    if nv_b.device != ext_b.device:
        raise ValueError("ext_b and nv_b must be on one device")
    if not (ext_b.is_contiguous() and nv_b.is_contiguous()):
        raise ValueError("ext_b and nv_b must be contiguous")
    P = ext_b.shape[1] - _HALO
    if P <= 0 or P % 32:
        raise ValueError(f"stream width P={P} must be a positive multiple of 32")
    if ext_b.numel() > _MAX_BATCH_BYTES:
        raise ValueError("batch exceeds the 2^31-byte dispatch budget")
    return P


def candidate_words_plain(ext_b: torch.Tensor, nv_b: torch.Tensor,
                          mask_s: int, mask_l: int):
    """Plain PyTorch version: gear ladder + masks + pack, (B, P/32) int32
    loose and strict words (u32 bits)."""
    _check(ext_b, nv_b)
    return _candidate_words(_hash_ext_fast(ext_b), nv_b, mask_s, mask_l)


def candidate_words(ext_b: torch.Tensor, nv_b: torch.Tensor, mask_s: int,
                    mask_l: int):
    """``(B, 31+P)`` u8, ``(B,)`` int32 -> ``(wl, ws)``, each ``(B, P/32)``
    int32 holding the u32 candidate words (loose, strict)."""
    P = _check(ext_b, nv_b)
    if ext_b.device.type == "cpu":
        return candidate_words_plain(ext_b, nv_b, mask_s, mask_l)
    if ext_b.device.type != "cuda":
        raise ValueError(f"unsupported device {ext_b.device}")
    from .. import kernels

    lib = kernels.library("scan_candidates")
    B = ext_b.shape[0]
    wl = torch.empty((B, P // 32), dtype=torch.int32, device=ext_b.device)
    ws = torch.empty_like(wl)
    with torch.cuda.device(ext_b.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bkw_scan_candidates(
            ext_b.data_ptr(), nv_b.data_ptr(), wl.data_ptr(), ws.data_ptr(),
            B, P, mask_s & 0xFFFFFFFF, mask_l & 0xFFFFFFFF, stream)
    kernels.check_launch(rc, "scan_candidates")
    candidate_words.launches += 1
    return wl, ws


candidate_words.launches = 0
