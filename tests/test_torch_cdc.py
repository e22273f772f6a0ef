"""Port's on-device CDC (``cdc_gpu``) vs the JAX package and the oracle.

The packed ``(B, 2+cut_cap)`` rows of ``scan_select_batch`` must equal the
JAX rows bit for bit (overflow flag, cut count, every end and the -1
padding); the chunk lists must equal ``cdc_cpu.chunk_stream``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from backuwup_tpu.ops import cdc_tpu as jax_cdc
from backuwup_tpu_torch.ops import cdc_cpu
from backuwup_tpu_torch.ops.cdc_gpu import (
    _HALO,
    GpuCdcScanner,
    _nonzero_static,
    scan_select_batch,
)
from backuwup_tpu_torch.ops.gear import CDCParams
from backuwup_tpu_torch.ops.pipeline import DevicePipeline

P = 64 * 1024


def _rows(kind, rng):
    """Eight rows per kind, so each parameter set compiles the JAX
    reference once."""
    if kind == "zeros":
        return [b"", bytes(P), bytes(P // 3)] + [bytes(64 << i)
                                                 for i in range(5)]
    if kind == "periodic":
        pat = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        return [(pat * 16)[:n] for n in (P, P - 999, 5000, 40_000, 4096,
                                         12_345, 30_000, 65)]
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in (P, P - 12345, 40_000, 1, 0, 20_000, 9_999, 64)]


def _batch(rows):
    buf = np.zeros((len(rows), _HALO + P), dtype=np.uint8)
    nv = np.zeros(len(rows), dtype=np.int32)
    for r, d in enumerate(rows):
        buf[r, _HALO:_HALO + len(d)] = np.frombuffer(d, dtype=np.uint8)
        nv[r] = len(d)
    return buf, nv


def _both(buf, nv, params, caps):
    s_cap, l_cap, cut_cap = caps
    kw = dict(min_size=params.min_size, desired_size=params.desired_size,
              max_size=params.max_size, mask_s=params.mask_s,
              mask_l=params.mask_l, s_cap=s_cap, l_cap=l_cap, cut_cap=cut_cap)
    port = scan_select_batch(torch.from_numpy(buf), torch.from_numpy(nv),
                             **kw).numpy()
    ref = np.asarray(jax_cdc.scan_select_batch(
        jnp.asarray(buf), jnp.asarray(nv), fused=False, **kw))
    return port, ref


@pytest.mark.parametrize("desired", [4096, 8192])
@pytest.mark.parametrize("kind", ["zeros", "periodic", "random"])
def test_scan_select_rows_match_jax_and_oracle(desired, kind):
    params = CDCParams.from_desired(desired)
    rows = _rows(kind, np.random.default_rng(desired))
    buf, nv = _batch(rows)
    caps = DevicePipeline(params, device="cpu")._caps(P)
    port, ref = _both(buf, nv, params, caps)
    assert port.dtype == np.int32 and port.shape == ref.shape
    assert np.array_equal(port, ref)
    for r, data in enumerate(rows):
        assert port[r, 0] == 0
        n = int(port[r, 1])
        ends = port[r, 2:2 + n].astype(np.int64)
        offs = np.concatenate([[0], ends[:-1] + 1]) if n else ends
        assert list(zip(offs.tolist(), (ends - offs + 1).tolist())) == \
            cdc_cpu.chunk_stream(data, params)


def test_overflowed_row_flags_like_jax_and_reruns_on_the_oracle(monkeypatch):
    params = CDCParams.from_desired(4096)
    rows = _rows("random", np.random.default_rng(9))
    buf, nv = _batch(rows)
    # 16 loose slots cannot hold a full row's ~64 candidates
    port, ref = _both(buf, nv, params, (16, 16, P // params.min_size + 1))
    assert np.array_equal(port, ref)
    assert port[0, 0] == 1 and port[7, 0] == 0

    pipe = DevicePipeline(params, device="cpu")
    monkeypatch.setattr(pipe, "_caps", lambda padded: (
        16, 16, padded // params.min_size + 1))
    out = pipe.manifest_batch(rows)
    assert [c for c, _ in out] == [cdc_cpu.chunk_stream(d, params)
                                   for d in rows]
    assert pipe.oracle_reruns >= 1 and pipe.pool_reruns == 0
    pipe.strict_overflow = True
    with pytest.raises(RuntimeError, match="overflow"):
        pipe.manifest_batch(rows)


def test_nonzero_static_matches_numpy():
    rng = np.random.default_rng(4)
    mask = rng.random((3, 50)) < 0.3
    mask[1] = False
    got = _nonzero_static(torch.from_numpy(mask), 8, 50).numpy()
    for r in range(3):
        want = np.flatnonzero(mask[r])[:8]
        assert got[r].tolist() == want.tolist() + [50] * (8 - len(want))


@pytest.mark.parametrize("segment", [64 * 1024, 96 * 1024])
def test_long_stream_scanner_matches_oracle_across_segments(segment):
    params = CDCParams.from_desired(4096)
    rng = np.random.default_rng(segment)
    data = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    data += bytes(50_000) + data[:70_000]
    scanner = GpuCdcScanner(params, segment_size=segment, device="cpu")
    assert scanner.chunk_stream(data) == cdc_cpu.chunk_stream(data, params)
    ref = jax_cdc.TpuCdcScanner(params, segment_size=segment)
    pos_s, pos_l = scanner.candidate_positions(data)
    rs, rl = ref.candidate_positions(data)
    assert np.array_equal(pos_s, rs) and np.array_equal(pos_l, rl)
