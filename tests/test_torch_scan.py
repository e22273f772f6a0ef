"""Port's candidate words (plain version of the CUDA scan kernel) vs the
JAX package: the Pallas v2 kernel in interpret mode and the XLA ladder.

All comparisons are bit-exact (tolerance 0): candidate words are integers.
The kernel itself runs only on the card: ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import pallas_interpret_works
from backuwup_tpu.ops import scan_fused as jax_scan_fused
from backuwup_tpu.ops.cdc_tpu import _candidate_words as jax_candidate_words
from backuwup_tpu.ops.cdc_tpu import _hash_ext_fast as jax_hash_ext_fast
from backuwup_tpu_torch.ops import scan_fused
from backuwup_tpu_torch.ops.cdc_gpu import _hash_ext_fast

MASK_S, MASK_L = 0xFFF00000, 0xFFF80000
CASES = ["random", "zeros", "short_rows", "min_p", "single_row"]


def _case(case):
    rng = np.random.default_rng(42)
    P = 4096 if case == "min_p" else 64 * 1024
    B = 1 if case == "single_row" else 2
    ext = rng.integers(0, 256, (B, 31 + P), dtype=np.uint8)
    if case == "zeros":
        ext[0] = 0
    nv = np.full(B, P, dtype=np.int32)
    if case == "short_rows":
        nv[1] = P - 12345
    return ext, nv


def _port_words(ext, nv, mask_s=MASK_S, mask_l=MASK_L):
    wl, ws = scan_fused.candidate_words(torch.from_numpy(ext),
                                        torch.from_numpy(nv), mask_s, mask_l)
    return wl.numpy().view(np.uint32), ws.numpy().view(np.uint32)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_xla_ladder(case):
    ext, nv = _case(case)
    wl, ws = _port_words(ext, nv)
    for r in range(ext.shape[0]):
        h = jax_hash_ext_fast(jnp.asarray(ext[r]))
        assert np.array_equal(
            _hash_ext_fast(torch.from_numpy(ext[r])).numpy().astype(np.uint32),
            np.asarray(h))
        rl, rs = jax_candidate_words(h, jnp.int32(nv[r]), jnp.uint32(MASK_S),
                                     jnp.uint32(MASK_L))
        assert np.array_equal(wl[r], np.asarray(rl)), case
        assert np.array_equal(ws[r], np.asarray(rs)), case


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_interpret(case):
    if not pallas_interpret_works():  # pragma: no cover
        pytest.skip("pallas interpret mode unavailable on this host")
    ext, nv = _case(case)
    wl, ws = _port_words(ext, nv)
    rl, rs = jax_scan_fused._fused_candidate_words_u32(
        jnp.asarray(ext), jnp.asarray(nv), mask_s=MASK_S, mask_l=MASK_L,
        interpret=True)
    assert np.array_equal(wl, np.asarray(rl)), case
    assert np.array_equal(ws, np.asarray(rs)), case


def test_wrapper_rejects_bad_inputs():
    ext = torch.zeros(2, 31 + 64, dtype=torch.uint8)
    nv = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        scan_fused.candidate_words(torch.zeros(2, 31 + 40, dtype=torch.uint8),
                                   nv, MASK_S, MASK_L)
    with pytest.raises(TypeError):
        scan_fused.candidate_words(ext, nv.long(), MASK_S, MASK_L)
    with pytest.raises(ValueError):
        scan_fused.candidate_words(ext[:, ::2], nv, MASK_S, MASK_L)
    # the plain path never counts as a kernel launch
    before = scan_fused.candidate_words.launches
    scan_fused.candidate_words(ext, nv, MASK_S, MASK_L)
    assert scan_fused.candidate_words.launches == before

