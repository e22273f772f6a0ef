"""Port's leaf-pool digest and zero-round-trip batch vs the JAX package.

``pool_digest`` is held against JAX ``pool_digest(pallas=False)`` on the
cases of ``tests/test_digest_pool.py`` (accumulator and overflow count,
bit-exact), and the planners against the reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from backuwup_tpu.ops import digest_pool as jax_pool
from backuwup_tpu.ops import manifest_device as jax_md
from backuwup_tpu.ops.gear import CDCParams as JaxCDCParams
from backuwup_tpu_torch.ops import manifest_device
from backuwup_tpu_torch.ops.blake3_cpu import blake3_hash
from backuwup_tpu_torch.ops.cdc_gpu import _HALO
from backuwup_tpu_torch.ops.digest_pool import (
    leaf_capacity,
    pool_digest,
    tier_spans,
)
from backuwup_tpu_torch.ops.gear import CDCParams
from backuwup_tpu_torch.ops.pipeline import DevicePipeline

SMALL = CDCParams.from_desired(4096)


def _both(flat, offs, lens, C, tiers=None, leaf_cap=None):
    offs_a = np.zeros(C, np.int32)
    lens_a = np.zeros(C, np.int32)
    offs_a[:len(offs)] = offs
    lens_a[:len(lens)] = lens
    if tiers is None:
        tiers = tuple((s, C) for s in tier_spans(256))
    if leaf_cap is None:
        leaf_cap = leaf_capacity(len(flat), C)
    flat_p = np.concatenate([flat, np.zeros(1024, np.uint8)])
    acc, ovf = pool_digest(torch.from_numpy(flat_p), torch.from_numpy(offs_a),
                           torch.from_numpy(lens_a), leaf_cap=leaf_cap,
                           tiers=tiers)
    racc, rovf = jax_pool.pool_digest(
        jnp.asarray(flat_p), jnp.asarray(offs_a), jnp.asarray(lens_a),
        leaf_cap=leaf_cap, tiers=tiers, pallas=False)
    acc = acc.numpy().view(np.uint32)
    assert np.array_equal(acc, np.asarray(racc))
    assert int(ovf[0]) == int(np.asarray(rovf)[0])
    return acc, int(ovf[0])


def _digests(acc):
    return [row.astype("<u4").tobytes() for row in acc]


def test_pool_digest_every_structural_edge():
    rng = np.random.default_rng(5)
    flat = rng.integers(0, 256, 512 * 1024, dtype=np.uint8)
    lens = [1, 2, 63, 64, 65, 1023, 1024, 1025, 2048, 2049, 5 * 1024,
            17 * 1024 + 7, 64 * 1024, 100_000]
    offs = list(np.cumsum([0] + lens[:-1]))
    acc, ovf = _both(flat, offs, lens, C=20)
    assert ovf == 0
    for i, (o, n) in enumerate(zip(offs, lens)):
        assert _digests(acc)[i] == blake3_hash(flat[o:o + n].tobytes()), n


def test_pool_digest_overlapping_and_shuffled_spans():
    rng = np.random.default_rng(6)
    # same pool shape as the case above: one JAX compile serves both
    flat = rng.integers(0, 256, 512 * 1024, dtype=np.uint8)
    spans = [(0, 10_000), (5_000, 10_000), (5_000, 3_000),
             (200_000, 50_000), (1, 1), (0, 256 * 1024)]
    rng.shuffle(spans)
    acc, ovf = _both(flat, [o for o, _ in spans], [n for _, n in spans], C=20)
    assert ovf == 0
    for i, (o, n) in enumerate(spans):
        assert _digests(acc)[i] == blake3_hash(flat[o:o + n].tobytes())


@pytest.mark.parametrize("tiers,overflows", [(((4, 4), (8, 8)), False),
                                             (((4, 4), (8, 2)), True)])
def test_pool_digest_tier_cascade_and_terminus_overflow(tiers, overflows):
    rng = np.random.default_rng(8)
    flat = rng.integers(0, 256, 64 * 1024, dtype=np.uint8)
    offs = [i * 4096 for i in range(8)]
    acc, ovf = _both(flat, offs, [4096] * 8, C=8, tiers=tiers)
    assert (ovf > 0) == overflows
    if not overflows:
        for i, o in enumerate(offs):
            assert _digests(acc)[i] == blake3_hash(flat[o:o + 4096].tobytes())


def test_pool_digest_leaf_cap_shortfall_flagged():
    flat = np.zeros(32 * 1024, np.uint8)
    _, ovf = _both(flat, [0, 8192], [8192, 8192], C=4,
                   tiers=((8, 4), (16, 4)), leaf_cap=8)
    assert ovf > 0  # 16 leaves needed, 8 lanes available


@pytest.mark.parametrize("desired", [4096, 64 * 1024, 1 << 20])
def test_planners_equal_reference(desired):
    port, ref = CDCParams.from_desired(desired), JaxCDCParams.from_desired(
        desired)
    assert manifest_device.class_leaf_sizes(port) == \
        jax_md.class_leaf_sizes(ref)
    assert manifest_device._length_histogram(port) == \
        jax_md._length_histogram(ref)
    for total, rows in ((4 << 20, 4), (128 << 20, 1), (128 << 20, 64)):
        assert manifest_device.tier_plan(port, total, rows) == \
            jax_md.tier_plan(ref, total, rows)
        assert leaf_capacity(total, rows * 9) == \
            jax_pool.leaf_capacity(total, rows * 9)
    assert tier_spans(3072) == jax_pool.tier_spans(3072)


def test_scan_digest_batch_pool_matches_jax():
    P = 65536
    rng = np.random.default_rng(13)
    rows = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (P, 30_000, 0, 1, 5000)]
    buf = np.zeros((len(rows), _HALO + P), dtype=np.uint8)
    nv = np.zeros(len(rows), dtype=np.int32)
    for r, d in enumerate(rows):
        buf[r, _HALO:_HALO + len(d)] = np.frombuffer(d, dtype=np.uint8)
        nv[r] = len(d)
    s_cap, l_cap, cut_cap = DevicePipeline(SMALL, device="cpu")._caps(P)
    kw = dict(min_size=SMALL.min_size, desired_size=SMALL.desired_size,
              max_size=SMALL.max_size, mask_s=SMALL.mask_s,
              mask_l=SMALL.mask_l, s_cap=s_cap, l_cap=l_cap, cut_cap=cut_cap,
              leaf_cap=leaf_capacity(len(rows) * P, len(rows) * cut_cap),
              tiers=manifest_device.tier_plan(SMALL, len(rows) * P, len(rows)))
    packed, acc, ovf = manifest_device.scan_digest_batch_pool(
        torch.from_numpy(buf), torch.from_numpy(nv), **kw)
    rp, racc, rovf = jax_md.scan_digest_batch_pool(
        jnp.asarray(buf), jnp.asarray(nv), fused=False, pallas_digest=False,
        **kw)
    assert np.array_equal(packed.numpy(), np.asarray(rp))
    assert np.array_equal(acc.numpy().view(np.uint32), np.asarray(racc))
    assert int(ovf[0]) == int(np.asarray(rovf)[0]) == 0
