"""The slice as a whole: ``GpuBackend.manifest_many`` (plain versions on
the CPU) vs the JAX ``TpuBackend`` on the CPU and the oracle backend.

The corpus covers every route of ``DevicePipeline.manifest_batch``: empty
and tiny streams (the batched digest), streams batched into one 64 KiB
bucket (scan -> select -> leaf pool), and long streams over a reduced
``segment_size`` (segmented scan + ``digest_chunks``).  Stream sizes are
chosen so the JAX reference compiles few shapes.
"""

import numpy as np
import pytest

from backuwup_tpu.ops.backend import CpuBackend as JaxCpuBackend
from backuwup_tpu.ops.backend import TpuBackend
from backuwup_tpu.ops.gear import GEAR as JAX_GEAR
from backuwup_tpu.ops.gear import CDCParams as JaxCDCParams
from backuwup_tpu_torch import carry
from backuwup_tpu_torch.ops.backend import CpuBackend, GpuBackend
from backuwup_tpu_torch.ops.gear import CDCParams

SEGMENT = 64 * 1024


def _corpus():
    rng = np.random.default_rng(21)
    sizes = [0, 1, 700, 1024, 1500, 4096, 20_000, 40_000, 65_536,
             150_000, 200_000]
    streams = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
               for n in sizes]
    streams.append(bytes(30_000))            # batched, candidate-free
    streams.append(streams[-2][:90_000] * 2)  # long, repeated content
    return streams


def _as_tuples(manifests):
    return [[(r.offset, r.length, r.hash) for r in refs] for refs in manifests]


def test_manifest_many_matches_jax_and_oracle():
    ref_params = JaxCDCParams.from_desired(4096)
    params = carry.cdc_params_from_reference(ref_params)
    assert params == CDCParams.from_desired(4096)
    streams = _corpus()

    gpu = GpuBackend(params, device="cpu", strict_overflow=True)
    gpu.pipeline.scanner.segment_size = SEGMENT
    got = _as_tuples(gpu.manifest_many(streams))
    assert gpu.pipeline.oracle_reruns == 0 and gpu.pipeline.pool_reruns == 0

    tpu = TpuBackend(ref_params)
    tpu.pipeline.scanner.segment_size = SEGMENT
    assert got == _as_tuples(tpu.manifest_many(streams))
    assert got == _as_tuples(CpuBackend(params).manifest_many(streams))
    assert got == _as_tuples(JaxCpuBackend(ref_params).manifest_many(streams))
    # every route ran: tiny, batched and long streams all produced chunks
    assert [len(m) for m in got][:4] == [0, 1, 1, 1]
    assert len(got[-1]) > 1 and len(got[-3]) > 1


def test_default_params_full_pool_spans_match_oracle():
    """Default chunking (256 KiB / 1 MiB / 3 MiB) on one 8 MiB bucket: the
    leaf pool's tiers up to the 3072-leaf span, including the terminus
    (candidate-free zeros cut at exactly max_size)."""
    rng = np.random.default_rng(5)
    streams = [rng.integers(0, 256, 8 << 20, dtype=np.uint8).tobytes(),
               bytes(7 << 20)]
    params = CDCParams()
    gpu = GpuBackend(params, device="cpu", strict_overflow=True)
    got = _as_tuples(gpu.manifest_many(streams))
    assert got == _as_tuples(CpuBackend(params).manifest_many(streams))
    assert [n for _o, n, _h in got[1]] == [3 << 20, 3 << 20, 1 << 20]
    assert max(n for _o, n, _h in got[0]) > 768 * 1024


def test_manifest_stream_matches_manifest():
    params = CDCParams.from_desired(4096)
    data = _corpus()[-3]
    gpu = GpuBackend(params, device="cpu")
    pos = [0]

    def read(n):
        piece = data[pos[0]:pos[0] + n]
        pos[0] += len(piece)
        return piece

    assert gpu.manifest_stream(read, segment_bytes=70_000) == \
        gpu.manifest(data)


def test_carry_reference_state():
    for ref in (JaxCDCParams(), JaxCDCParams.from_desired(64 * 1024)):
        p = carry.cdc_params_from_reference(ref)
        assert (p.min_size, p.desired_size, p.max_size, p.mask_s, p.mask_l) \
            == (ref.min_size, ref.desired_size, ref.max_size, ref.mask_s,
                ref.mask_l)
    assert carry.gear_table_matches(JAX_GEAR)
    bad = JAX_GEAR.copy()
    bad[7] ^= 1
    with pytest.raises(ValueError):
        carry.gear_table_matches(bad)
    buf = np.zeros((2, 31 + 64), np.uint8)
    ext, nv = carry.batch_from_reference(buf, np.array([64, 3]), device="cpu")
    assert ext.shape == (2, 95) and nv.tolist() == [64, 3]
    with pytest.raises(ValueError):
        carry.batch_from_reference(buf, np.array([65, 3]), device="cpu")
