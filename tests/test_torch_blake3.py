"""Port's BLAKE3 (``blake3_gpu``: plain version of the CUDA leaf kernel +
the tree) vs the JAX package's Pallas leaf kernel in interpret mode and
the spec oracle.  Bit-exact throughout: chaining values are integers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import pallas_interpret_works
from backuwup_tpu.ops import blake3_tpu as jax_b3
from backuwup_tpu_torch.ops import blake3_gpu
from backuwup_tpu_torch.ops.blake3_cpu import blake3_hash, blake3_many

LENS = [0, 1, 64, 65, 1024, 1025, 4000, 8192]


def _needs_interpret():
    if not pallas_interpret_works():  # pragma: no cover
        pytest.skip("pallas interpret mode unavailable on this host")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_digest_padded_matches_pallas_interpret_and_spec():
    _needs_interpret()
    rng = np.random.default_rng(11)
    L = 8
    buf = rng.integers(0, 256, (len(LENS), L * 1024), dtype=np.uint8)
    lens = np.array(LENS, dtype=np.int32)
    got = _u32(blake3_gpu.digest_padded(torch.from_numpy(buf),
                                        torch.from_numpy(lens), L=L))
    ref = np.asarray(jax_b3.digest_padded(
        jnp.asarray(buf), jnp.asarray(lens), L=L, pallas=True,
        pallas_interpret=True))
    assert np.array_equal(got, ref)
    for i, n in enumerate(LENS):
        assert got[i].astype("<u4").tobytes() == blake3_hash(
            buf[i, :n].tobytes()), n


def test_leaf_scan_plain_matches_pallas_over_two_grid_steps():
    _needs_interpret()
    rng = np.random.default_rng(12)
    lanes = 4096 + 300  # more than one 4096-lane grid step
    words = rng.integers(0, 2**32, (lanes, 256), dtype=np.uint64).astype(
        np.uint32)
    nb = rng.integers(1, 17, lanes).astype(np.int32)
    lbl = rng.integers(1, 65, lanes).astype(np.int32)
    ctr = rng.integers(0, 5000, lanes).astype(np.int32)
    cv, cvp = blake3_gpu.leaf_scan_plain(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(nb),
        torch.from_numpy(lbl), torch.from_numpy(ctr))
    rcv, rcvp = jax_b3._leaf_scan_pallas(
        jnp.asarray(words.reshape(lanes, 16, 16)), jnp.asarray(nb),
        jnp.asarray(lbl.astype(np.uint32)), jnp.asarray(ctr), interpret=True)
    assert np.array_equal(_u32(cv), np.asarray(rcv))
    assert np.array_equal(_u32(cvp), np.asarray(rcvp))


@pytest.mark.parametrize("L", [3, 5, 7])
def test_tree_reduce_on_odd_leaf_counts(L):
    rng = np.random.default_rng(L)
    B = 6
    leaf = rng.integers(0, 2**32, (8, B, L), dtype=np.uint64).astype(np.uint32)
    counts = np.array([1, 2, L, L - 1, (L + 1) // 2, L], dtype=np.int32)
    seed = rng.integers(0, 2**32, (8, B), dtype=np.uint64).astype(np.uint32)
    got = blake3_gpu.tree_reduce_cvs(
        [torch.from_numpy(c.astype(np.int64)) for c in leaf],
        torch.from_numpy(counts),
        [torch.from_numpy(c.astype(np.int64)) for c in seed])
    ref = jax_b3.tree_reduce_cvs([jnp.asarray(c) for c in leaf],
                                 jnp.asarray(counts),
                                 [jnp.asarray(c) for c in seed])
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(ref))


def test_blake3_many_gpu_matches_spec_on_odd_leaf_counts():
    rng = np.random.default_rng(5)
    datas = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
             for n in (3 * 1024 + 5, 5 * 1024, 7 * 1024 - 1, 17 * 1024 + 7,
                       0, 33, 70_000)]
    assert blake3_gpu.blake3_many_gpu(datas, device="cpu") == \
        blake3_many(datas)


def test_leaf_scan_wrapper_checks_inputs():
    w = torch.zeros(4, 256, dtype=torch.int32)
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        blake3_gpu.leaf_scan(w[:, :128], z, z, z)
    with pytest.raises(TypeError):
        blake3_gpu.leaf_scan(w, z.long(), z, z)
    before = blake3_gpu.leaf_scan.launches
    blake3_gpu.leaf_scan(w, z + 1, z + 64, z)
    assert blake3_gpu.leaf_scan.launches == before  # plain path: no launch

