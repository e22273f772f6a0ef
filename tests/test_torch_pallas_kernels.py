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
