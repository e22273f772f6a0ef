"""Batched Reed-Solomon encode/decode on the device: the GF(2^8) product.

Counterpart of ``backuwup_tpu/erasure/rs_tpu.py``, same contracts:

* :func:`gf_matmul_stripes` -- ``(mat (r, j), stripes (B, j, L))`` numpy
  uint8 -> ``(B, r, L)`` numpy uint8, ``out[b, i, l] = XOR_j mat[i, j] *
  stripes[b, j, l]`` in GF(2^8);
* :func:`encode_stripes` -- ``(B, k, L)`` data shards -> ``(B, m, L)``
  parity shards; ``m == 0`` or ``B == 0`` gives zeros without a launch;
* :func:`decode_stripes` -- ``(B, k, L)`` surviving shards, rows in sorted
  ``present`` order (``present`` deduplicated and sorted) -> the ``(B, k,
  L)`` data shards.  The k x k inversion stays on the host
  (:func:`.gf_cpu.decode_matrix`).

Each takes an explicit ``device`` (``None`` is CUDA, and raises without
it).  On CUDA a call is one upload from pinned staging (the stripes and the
matrix in one buffer), one launch of the kernel ``csrc/gf_matmul.cu`` (K6)
through :func:`gf_matmul`, and one download.  On the CPU it runs the plain
version, :func:`gf_matmul_plain`: a ``MUL_TABLE`` gather and an XOR over
``j`` with ``^=`` (torch has no XOR reduction), stripe by stripe over tiles
of ``L`` so that its int64 gather indices stay bounded (the reference's
whole (r, j, L) gather would be 64 B per shard byte).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from . import gf_cpu

# columns per step of the plain version: 8 MiB of int64 indices per row
_PLAIN_TILE = 1 << 20

_tables: Dict[torch.device, torch.Tensor] = {}


def _mul_table(device: torch.device) -> torch.Tensor:
    t = _tables.get(device)
    if t is None:
        t = torch.from_numpy(gf_cpu.MUL_TABLE.copy()).to(device)
        _tables[device] = t
    return t


def _check(mat: torch.Tensor, stripes: torch.Tensor) -> None:
    if mat.dtype != torch.uint8 or stripes.dtype != torch.uint8:
        raise TypeError("mat and stripes must be uint8 tensors")
    if mat.dim() != 2 or stripes.dim() != 3:
        raise ValueError("mat must be (r, j) and stripes (B, j, L)")
    if mat.shape[1] != stripes.shape[1]:
        raise ValueError(f"mat has {mat.shape[1]} columns, stripes "
                         f"{stripes.shape[1]} rows")
    if not 1 <= mat.shape[0] <= 256 or not 1 <= mat.shape[1] <= 256:
        raise ValueError(f"unsupported matrix shape {tuple(mat.shape)}")
    if mat.device != stripes.device:
        raise ValueError("mat and stripes lie on different devices")


def gf_matmul_plain(mat: torch.Tensor, stripes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version on any device: the product table's rows that
    ``mat`` selects, gathered by each input byte and XORed over ``j``."""
    _check(mat, stripes)
    b_n, j_n, ln = stripes.shape
    rows = _mul_table(stripes.device)[mat.long()]  # (r, j, 256)
    out = torch.zeros((b_n, mat.shape[0], ln), dtype=torch.uint8,
                      device=stripes.device)
    for b in range(b_n):
        for l0 in range(0, ln, _PLAIN_TILE):
            acc = out[b, :, l0:l0 + _PLAIN_TILE]
            for j in range(j_n):
                x = stripes[b, j, l0:l0 + _PLAIN_TILE].long()
                acc ^= rows[:, j, :][:, x]
    return out


def gf_matmul(mat: torch.Tensor, stripes: torch.Tensor) -> torch.Tensor:
    """``(r, j)`` x ``(B, j, L)`` uint8 -> ``(B, r, L)`` uint8 on the
    tensors' device: K6 on CUDA, the plain version on the CPU."""
    _check(mat, stripes)
    if stripes.device.type == "cpu":
        return gf_matmul_plain(mat, stripes)
    if stripes.device.type != "cuda":
        raise ValueError(f"unsupported device {stripes.device}")
    from .. import kernels

    mat = mat.contiguous()
    stripes = stripes.contiguous()
    b_n, j_n, ln = stripes.shape
    r = mat.shape[0]
    out = torch.empty((b_n, r, ln), dtype=torch.uint8, device=stripes.device)
    if out.numel() == 0:
        return out
    lib = kernels.library("gf_matmul")
    with torch.cuda.device(stripes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.bkw_gf_matmul(mat.data_ptr(), stripes.data_ptr(),
                               out.data_ptr(), r, j_n, b_n, ln, stream)
    kernels.check_launch(rc, "gf_matmul")
    gf_matmul.launches += 1
    return out


gf_matmul.launches = 0


def gf_matmul_stripes(mat: np.ndarray, stripes: np.ndarray,
                      device=None) -> np.ndarray:
    """GF(2^8) matmul over a batch of stripes on ``device``; returns host
    uint8."""
    dev = resolve_device(device)
    mat = np.asarray(mat, dtype=np.uint8)
    stripes = np.asarray(stripes, dtype=np.uint8)
    if dev.type == "cpu":
        out = gf_matmul(torch.from_numpy(np.array(mat, order="C")),
                        torch.from_numpy(np.array(stripes, order="C")))
        return out.numpy()
    b_n, j_n, ln = stripes.shape
    n = stripes.size
    off = -(-n // 16) * 16  # the matrix after the stripes, 16-B aligned
    staging = torch.empty(off + mat.size, dtype=torch.uint8, pin_memory=True)
    host = staging.numpy()
    # strided views (``full[:, present, :]``, ``data[None]``) copy straight
    # into the pinned buffer: no intermediate contiguous copy
    np.copyto(host[:n].reshape(stripes.shape), stripes)
    np.copyto(host[off:].reshape(mat.shape), mat)
    buf = staging.to(dev, non_blocking=True)
    out = gf_matmul(buf[off:].view(mat.shape), buf[:n].view(b_n, j_n, ln))
    return out.cpu().numpy()


def encode_stripes(stripes: np.ndarray, m: int, device=None) -> np.ndarray:
    """(B, k, L) data shards -> (B, m, L) parity shards."""
    dev = resolve_device(device)
    stripes = np.asarray(stripes, dtype=np.uint8)
    b, k, ln = stripes.shape
    if m == 0 or b == 0:
        return np.zeros((b, m, ln), dtype=np.uint8)
    parity_rows = gf_cpu.generator_matrix(k, m)[k:]
    return gf_matmul_stripes(parity_rows, stripes, dev)


def decode_stripes(stripes: np.ndarray, k: int, m: int,
                   present: Sequence[int], device=None) -> np.ndarray:
    """(B, k, L) surviving shards (rows in sorted ``present`` order) ->
    (B, k, L) reconstructed data shards."""
    dev = resolve_device(device)
    stripes = np.asarray(stripes, dtype=np.uint8)
    if stripes.shape[0] == 0:
        return stripes
    cols = sorted(set(int(i) for i in present))
    rec = gf_cpu.decode_matrix(k, m, cols)[:, cols]
    return gf_matmul_stripes(rec, stripes, dev)
