"""Port's candidate words (plain version of the CUDA scan kernel) vs the
JAX package: the Pallas v2 kernel in interpret mode and the XLA ladder.

All comparisons are bit-exact (tolerance 0): candidate words are integers.
The kernel itself runs only on the card: ``tests/test_torch_cuda.py``.
"""

import functools

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
from backuwup_tpu_torch.ops.gear import GEAR_SEED32

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



# --- the CUDA kernel's rolling schedule, modelled in numpy ----------------

RUN_WORDS = [1, 2, 4]


def _fmix32(x):
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


def _rolling_model(ext, nv, m, mask_s=MASK_S, mask_l=MASK_L):
    """``csrc/scan_candidates.cu``'s decomposition: each run of ``32*m``
    positions starts from h = 0 at the 31 bytes before its first position
    and rolls ``h = (h << 1) + g`` over its ``32*m + 31`` bytes, packing
    words per run; bytes past a row's end read 0 and feed only positions
    past P, which are dropped.  Vectorised over rows and runs; the one
    Python loop is over the steps of a run.  Returns (h, wl, ws)."""
    B, W = ext.shape
    P = W - 31
    run = 32 * m
    n_runs = -(-P // run)
    e = np.zeros((B, n_runs * run + 31), dtype=np.uint8)
    e[:, :W] = ext
    idx = np.arange(n_runs)[:, None] * run + np.arange(run + 31)[None, :]
    g = _fmix32(e[:, idx].astype(np.uint32) + np.uint32(GEAR_SEED32))
    h = np.zeros((B, n_runs), dtype=np.uint32)
    hs = np.zeros((B, n_runs, run), dtype=np.uint32)
    for k in range(run + 31):
        h = (h << np.uint32(1)) + g[:, :, k]
        if k >= 31:
            hs[:, :, k - 31] = h
    hs = hs.reshape(B, n_runs * run)[:, :P]
    pos = np.arange(P)[None, :]
    cl = ((hs & np.uint32(mask_l)) == 0) & (pos < nv[:, None])
    cs = cl & ((hs & np.uint32(mask_s)) == 0)
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)

    def pack(bits):
        return (bits.reshape(B, P // 32, 32).astype(np.uint32)
                * weights).sum(axis=2, dtype=np.uint32)

    return hs, pack(cl), pack(cs)


@functools.lru_cache(maxsize=None)
def _pallas_words(case):
    ext, nv = _case(case)
    rl, rs = jax_scan_fused._fused_candidate_words_u32(
        jnp.asarray(ext), jnp.asarray(nv), mask_s=MASK_S, mask_l=MASK_L,
        interpret=True)
    return np.asarray(rl), np.asarray(rs)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("m", RUN_WORDS)
def test_rolling_schedule_matches_references(m, case):
    """The kernel's schedule (runs of 32*m positions, 31-byte warm-up,
    per-run words) equals the XLA ladder's hashes and words and the Pallas
    kernel in interpret mode; tolerance 0."""
    ext, nv = _case(case)
    h, wl, ws = _rolling_model(ext, nv, m)
    for r in range(ext.shape[0]):
        h_ref = jax_hash_ext_fast(jnp.asarray(ext[r]))
        assert np.array_equal(h[r], np.asarray(h_ref)), (m, case)
        rl, rs = jax_candidate_words(h_ref, jnp.int32(nv[r]),
                                     jnp.uint32(MASK_S), jnp.uint32(MASK_L))
        assert np.array_equal(wl[r], np.asarray(rl)), (m, case)
        assert np.array_equal(ws[r], np.asarray(rs)), (m, case)
    if not pallas_interpret_works():  # pragma: no cover
        pytest.skip("pallas interpret mode unavailable on this host")
    rl, rs = _pallas_words(case)
    assert np.array_equal(wl, rl) and np.array_equal(ws, rs), (m, case)


@pytest.mark.parametrize("m", RUN_WORDS)
def test_rolling_schedule_ragged_rows(m):
    """Rows shorter than one run and widths that are no multiple of a run
    (the last run passes the row's end), with valid lengths 0, 1, 31, 33
    and P: the model equals the port's plain version, itself held to the
    JAX package above."""
    rng = np.random.default_rng(17)
    # the second pair is loose enough to set bits in rows this short
    for mask_s, mask_l in ((MASK_S, MASK_L), (0xF0000000, 0xC0000000)):
        for P in (32, 96, 160, 32 * 13):
            ext = rng.integers(0, 256, (5, 31 + P), dtype=np.uint8)
            nv = np.array([0, 1, 31, min(33, P), P], dtype=np.int32)
            _h, wl, ws = _rolling_model(ext, nv, m, mask_s, mask_l)
            want = scan_fused.candidate_words_plain(
                torch.from_numpy(ext), torch.from_numpy(nv), mask_s, mask_l)
            assert np.array_equal(wl, want[0].numpy().view(np.uint32))
            assert np.array_equal(ws, want[1].numpy().view(np.uint32))
    assert wl.any() and ws.any()
