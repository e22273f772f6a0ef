"""The port's CUDA kernels and GPU path on the card (marked ``cuda``).

Each test skips here, where torch has no CUDA.  This file imports no JAX
and nothing of ``backuwup_tpu``, so on a machine with a card and without
JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from backuwup_tpu_torch.ops import blake3_gpu, scan_fused
from backuwup_tpu_torch.ops.backend import CpuBackend, GpuBackend
from backuwup_tpu_torch.ops.gear import CDCParams


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_scan_kernel_matches_plain():
    _needs_card()
    rng = np.random.default_rng(3)
    P = 1 << 20
    ext = torch.from_numpy(rng.integers(0, 256, (3, 31 + P), dtype=np.uint8))
    nv = torch.tensor([P, P - 12345, 77], dtype=torch.int32)
    ext_d, nv_d = ext.cuda(), nv.cuda()
    before = scan_fused.candidate_words.launches
    for mask_s, mask_l in ((0xFFF00000, 0xFFF80000), (0xFFFFC000, 0xFFF00000)):
        got = scan_fused.candidate_words(ext_d, nv_d, mask_s, mask_l)
        want = scan_fused.candidate_words_plain(ext_d, nv_d, mask_s, mask_l)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert scan_fused.candidate_words.launches == before + 2


@pytest.mark.cuda
def test_leaf_kernel_matches_plain():
    _needs_card()
    rng = np.random.default_rng(13)
    lanes = 70_001
    words = torch.from_numpy(rng.integers(
        0, 2**32, (lanes, 256), dtype=np.uint64).astype(np.uint32).view(
        np.int32)).cuda()
    nb = torch.from_numpy(rng.integers(0, 17, lanes).astype(np.int32)).cuda()
    lbl = torch.from_numpy(rng.integers(0, 65, lanes).astype(np.int32)).cuda()
    ctr = torch.from_numpy(rng.integers(0, 9000, lanes).astype(np.int32)).cuda()
    got = blake3_gpu.leaf_scan(words, nb, lbl, ctr)
    want = blake3_gpu.leaf_scan_plain(words, nb, lbl, ctr)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_gpu_backend_matches_oracle_backend():
    _needs_card()
    params = CDCParams.from_desired(4096)
    rng = np.random.default_rng(21)
    streams = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
               for n in (0, 1, 700, 5000, 40_000, 65_536, 300_000)]
    streams.append(bytes(30_000))
    gpu = GpuBackend(params, strict_overflow=True)
    gpu.pipeline.scanner.segment_size = 128 * 1024
    assert gpu.device.type == "cuda"
    assert gpu.manifest_many(streams) == CpuBackend(params).manifest_many(
        streams)
