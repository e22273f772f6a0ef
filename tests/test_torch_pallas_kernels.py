"""Gear values and flat-ladder candidates: the port's plain versions vs the
JAX package's Pallas kernels and the oracles.

Tolerance 0: every comparison is bit-exact through ``view(np.uint32)``.
The Pallas kernels run on the CPU in interpret mode, without editing the
JAX package: the module's ``pl`` is swapped (``monkeypatch``) for a copy
of ``jax.experimental.pallas`` whose ``pallas_call`` interprets.  Both
entry points are module-level ``jax.jit``s, so their caches are cleared around
each test; a trace made with the real ``pl`` would be reused.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jax_pallas

from backuwup_tpu.ops import pallas_kernels as pk
from backuwup_tpu.ops.cdc_cpu import gear_hashes
from backuwup_tpu.ops.gear import GEAR, CDCParams
from backuwup_tpu_torch.ops import pallas_kernels as port


@pytest.fixture
def interpret(monkeypatch):
    ns = types.SimpleNamespace(**{k: getattr(jax_pallas, k)
                                  for k in dir(jax_pallas)
                                  if not k.startswith("__")})
    calls = []

    def pallas_call(*args, **kwargs):
        calls.append(args[0])
        return jax_pallas.pallas_call(*args, interpret=True, **kwargs)

    ns.pallas_call = pallas_call
    monkeypatch.setattr(pk, "pl", ns)
    jitted = (pk.gear_values_pallas, pk.ladder_candidates_pallas)
    for f in jitted:
        f.clear_cache()
    yield calls
    for f in jitted:
        f.clear_cache()


def test_ladder_block_matches_reference():
    assert port.LADDER_BLOCK == pk._LADDER_ROWS * pk._LANES


@pytest.mark.parametrize(
    "n", [1, 255, pk._TILE_BYTES, pk._TILE_BYTES * 3 + 17, 1 << 20])
def test_gear_values_matches_pallas_and_table(interpret, n):
    b = np.random.default_rng(7 + n).integers(0, 256, n, dtype=np.uint8)
    got = port.gear_values(torch.from_numpy(b)).numpy().view(np.uint32)
    assert np.array_equal(got, GEAR[b])
    ref = np.asarray(pk.gear_values_pallas(jnp.asarray(b)))
    assert interpret == [pk._gear_kernel]  # traced through interpret mode
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("params,short", [
    (CDCParams(), 0),
    (CDCParams.from_desired(64 * 1024), 12_345),
], ids=["default", "64KiB"])
def test_ladder_candidates_match_pallas_and_oracle(interpret, params, short):
    n = 2 * port.LADDER_BLOCK
    n_valid = n - short
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, n - 31, dtype=np.uint8)
    ext = np.zeros(n, dtype=np.uint8)
    ext[31:] = data
    g = GEAR[ext].astype(np.uint32)
    cl, cs = port.ladder_candidates(torch.from_numpy(g.view(np.int32)),
                                    n_valid, mask_s=params.mask_s,
                                    mask_l=params.mask_l)
    cl, cs = cl.numpy(), cs.numpy()
    rl, rs = pk.ladder_candidates_pallas(jnp.asarray(g), n_valid,
                                         mask_s=params.mask_s,
                                         mask_l=params.mask_l)
    assert len(interpret) == 1
    assert np.array_equal(cl, np.asarray(rl))
    assert np.array_equal(cs, np.asarray(rs))
    # the oracle, given the same 31 zero bytes of left context
    h = gear_hashes(data, prev_tail=bytes(31))
    valid = np.arange(31, n) < n_valid
    cl_ref = ((h & np.uint32(params.mask_l)) == 0) & valid
    cs_ref = cl_ref & ((h & np.uint32(params.mask_s)) == 0)
    assert np.array_equal(cl[31:].astype(bool), cl_ref)
    assert np.array_equal(cs[31:].astype(bool), cs_ref)
    # 64 KiB masks: ~8 loose candidates in 2^17 positions, so the
    # comparison is not of all-zero vectors
    assert params.mask_l_bits > 16 or cl.sum() > 0


def test_wrappers_check_their_inputs():
    assert port.gear_values(torch.zeros(0, dtype=torch.uint8)).shape == (0,)
    with pytest.raises(TypeError):
        port.gear_values(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="ladder block"):
        port.ladder_candidates(torch.zeros(1000, dtype=torch.int32), 1000,
                               mask_s=1, mask_l=1)
    with pytest.raises(TypeError):
        port.ladder_candidates(torch.zeros(port.LADDER_BLOCK,
                                           dtype=torch.int64), 1,
                               mask_s=1, mask_l=1)


# --- csrc/ladder_candidates.cu's schedule, modelled on the CPU ----------

# (positions one thread owns, spans of 32 runs one warp walks): the
# kernel's is (16, 1), one 16-byte flag store per thread and mask; runs of
# 8 and 32 and warps that walk 4 spans passing the carry on timed within
# noise of it or slower on the card (scripts/torch_k3k4_variants.cu)
SCHEDULES = [(16, 1), (8, 1), (32, 1), (16, 4)]
_IDS = [f"run{r}-spans{s}" for r, s in SCHEDULES]
_WARPS = 8  # warps of a block


def _ladder_model(g, n_valid, run, spans, mask_s, mask_l):
    """The kernel's decomposition in numpy, vectorised over warps.

    A warp owns ``spans`` consecutive spans of 32 runs of ``run``
    positions.  Before its first span it sums ``g[p0 - 32 + j] << (31 -
    j)`` over its lanes (zeros before position 0): the exact hash at p0 -
    1, the carry.  In each span, every lane rolls its run from 0 to its
    local end L; the exact hash at the end of run t is the sum of L(t - j)
    << (j * run) over the runs of the last 32 positions, the carry taking
    the place of the runs before the span (for a run of 16: L(t) + (L(t-1)
    << 16), lane 0 taking the carry for L(-1)).  Each lane then rolls its
    exact hashes from the end of run t - 1 (lane 0 from the carry), and
    the last lane's end is the next span's carry.  Returns (h, cl, cs)."""
    g = np.asarray(g, dtype=np.uint32)
    n = g.shape[0]
    per_warp = spans * 32 * run
    assert n % per_warp == 0
    x = g.reshape(n // per_warp, spans, 32, run)
    one = np.uint32(1)
    local = np.zeros(x.shape[:3], dtype=np.uint32)
    for i in range(run):
        local = (local << one) + x[..., i]
    lanes = np.arange(32)
    idx = (np.arange(x.shape[0]) * per_warp)[:, None] - 32 + lanes[None, :]
    before = np.where(idx >= 0, g[np.maximum(idx, 0)], np.uint32(0))
    carry = (before << (31 - lanes).astype(np.uint32)).sum(
        axis=1, dtype=np.uint32)
    hs = np.empty(x.shape, dtype=np.uint32)
    for s in range(spans):
        lo = local[:, s]
        end = lo.copy()
        for j in range(1, -(-32 // run)):
            prev = np.zeros_like(lo)
            prev[:, j:] = lo[:, :-j]
            end += prev << np.uint32(j * run)
        shift = (lanes + 1) * run
        end += np.where(shift < 32,
                        carry[:, None] << np.minimum(shift, 31).astype(
                            np.uint32), np.uint32(0))
        h = np.empty_like(lo)
        h[:, 0] = carry
        h[:, 1:] = end[:, :-1]
        carry = end[:, 31].copy()
        for i in range(run):
            h = (h << one) + x[:, s, :, i]
            hs[:, s, :, i] = h
    h = hs.reshape(n)
    valid = np.arange(n) < n_valid
    cl = ((h & np.uint32(mask_l)) == 0) & valid
    cs = cl & ((h & np.uint32(mask_l | mask_s)) == 0)
    return h, cl.astype(np.uint8), cs.astype(np.uint8)


_LADDER_MASKS = [(CDCParams().mask_s, CDCParams().mask_l),
                 (CDCParams.from_desired(64 * 1024).mask_s,
                  CDCParams.from_desired(64 * 1024).mask_l),
                 (0xF0000000, 0xC0000000)]  # sets a quarter of the flags


@pytest.mark.parametrize("run,spans", SCHEDULES, ids=_IDS)
def test_ladder_schedule_model_matches_pallas_and_oracle(interpret, run,
                                                         spans):
    """Tolerance 0: the model's hashes equal ``cdc_cpu.gear_hashes`` of
    the bytes behind the gear values (no left context, so the zero
    history before position 0 is the oracle's too), and its flags equal
    the Pallas kernel's in interpret mode and the port's plain version,
    with n_valid at 0, 1, 31, 33, around a run, a span, a warp's spans,
    a block and a ladder block, and at n."""
    n = 2 * port.LADDER_BLOCK
    data = np.random.default_rng(40 + run + spans).integers(
        0, 256, n, dtype=np.uint8)
    g = GEAR[data].astype(np.uint32)
    h_ref = gear_hashes(data)
    span = 32 * run
    n_valids = [0, 1, 31, 33]
    for edge in (run, span, spans * span, _WARPS * spans * span,
                 port.LADDER_BLOCK):
        n_valids += [edge - 1, edge + 1]
    n_valids.append(n)
    for mask_s, mask_l in _LADDER_MASKS:
        for n_valid in n_valids:
            h, cl, cs = _ladder_model(g, n_valid, run, spans, mask_s,
                                      mask_l)
            assert np.array_equal(h, h_ref)
            rl, rs = pk.ladder_candidates_pallas(
                jnp.asarray(g), n_valid, mask_s=mask_s, mask_l=mask_l)
            assert np.array_equal(cl, np.asarray(rl)), (mask_l, n_valid)
            assert np.array_equal(cs, np.asarray(rs)), (mask_l, n_valid)
            pl_, ps_ = port.ladder_candidates_plain(
                torch.from_numpy(g.view(np.int32)), n_valid, mask_s=mask_s,
                mask_l=mask_l)
            assert np.array_equal(cl, pl_.numpy())
            assert np.array_equal(cs, ps_.numpy())
    assert len(interpret) == len(_LADDER_MASKS)  # one trace per mask pair
    assert cl.sum() > n // 8 and cs.sum() > 0  # the loose pair at n


@pytest.mark.parametrize("run,spans", SCHEDULES, ids=_IDS)
def test_ladder_schedule_model_carry_across_warps(run, spans):
    """Random gear words (not only table values): the model equals the
    plain version's five doubling passes at every position, so the
    warm-up and the carry between spans and warps hold for any input."""
    n = port.LADDER_BLOCK
    g = np.random.default_rng(50 + run + spans).integers(
        0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    mask_s, mask_l = 0xF0000000, 0xC0000000
    for n_valid in (0, 17, 32 * run + 1, n):
        _h, cl, cs = _ladder_model(g, n_valid, run, spans, mask_s, mask_l)
        pl_, ps_ = port.ladder_candidates_plain(
            torch.from_numpy(g.view(np.int32)), n_valid, mask_s=mask_s,
            mask_l=mask_l)
        assert np.array_equal(cl, pl_.numpy()), n_valid
        assert np.array_equal(cs, ps_.numpy()), n_valid
