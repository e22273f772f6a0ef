"""The slice as a whole: ``GpuBackend.manifest_many_classified`` (the
one-pass dedup handoff, plain versions on the CPU) vs the JAX package's
two-pass ``CpuBackend().manifest_many_classified`` with its
``MeshDedupIndex``.

The JAX one-pass path (``TpuBackend`` over the mesh pipeline) does not run
on the CPU (``test_mesh_pipeline.py``), so the port is held against the
two-pass path, whose hints the packer requires the one-pass path to equal.
Tolerance 0: manifests and hints must be equal.  The corpus has repeats
across and within streams, tiny and empty streams, a long stream, and a
bucket whose rows overflow (candidates, or the leaf pool) so that their
flags come back unclassified and the host authority answers.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from backuwup_tpu.crypto import KeyManager
from backuwup_tpu.ops import dedup_index as ref_index
from backuwup_tpu.ops.backend import CpuBackend as RefCpuBackend
from backuwup_tpu.ops.gear import CDCParams as RefParams
from backuwup_tpu.snapshot.blob_index import BlobIndex
from backuwup_tpu.snapshot.device_dedup import MeshDedupIndex as RefIndex
from backuwup_tpu_torch import carry
from backuwup_tpu_torch.ops import pipeline as port_pipeline
from backuwup_tpu_torch.ops.backend import GpuBackend
from backuwup_tpu_torch.ops.dedup_index import hashes_to_queries
from backuwup_tpu_torch.ops.gear import CDCParams
from backuwup_tpu_torch.snapshot.device_dedup import MeshDedupIndex

SEGMENT = 128 * 1024


def _corpus():
    rng = np.random.default_rng(41)

    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    a, b, small = rand(70_000), rand(100_000), rand(40_000)
    tiny = rand(700)
    return [
        a, b, a,                       # 128 KiB bucket, a repeat
        bytes(90_000),                 # repeats within one row
        small + b[:60_000],            # shares small's leading chunks
        small, small,                  # 64 KiB bucket (the overflow one)
        tiny, tiny, rand(1024), b"",   # tiny and empty
        a + b + rand(130_000),         # long path, shares a's chunks
    ]


def _as_tuples(manifests):
    return [[(r.offset, r.length, r.hash) for r in refs] for refs in manifests]


def _authorities(tmp_path):
    keys = KeyManager.from_secret(b"\x09" * 32)
    return (BlobIndex(keys, tmp_path / "port"),
            BlobIndex(keys, tmp_path / "ref"))


@pytest.mark.parametrize("overflow", ["candidates", "pool"])
@pytest.mark.parametrize("n_shards", [1, 8])
def test_one_pass_hints_match_the_two_pass_reference(tmp_path, monkeypatch,
                                                     overflow, n_shards):
    params = CDCParams.from_desired(4096)
    streams = _corpus()
    gpu = GpuBackend(params, device="cpu")
    pipe = gpu.pipeline
    pipe.scanner.segment_size = SEGMENT
    if overflow == "candidates":
        # 16 loose slots cannot hold a 40 KB row's ~40 candidates
        caps = pipe._caps
        monkeypatch.setattr(pipe, "_caps", lambda padded: (
            (16, 16, padded // params.min_size + 1) if padded == 65536
            else caps(padded)))
    else:
        plan = port_pipeline.tier_plan
        monkeypatch.setattr(port_pipeline, "tier_plan", lambda p, total, n: (
            tuple((span, 1) for span, _ in plan(p, total, n))
            if total == 2 * 65536 else plan(p, total, n)))
    host, ref_host = _authorities(tmp_path)
    dedup = MeshDedupIndex(host, n_shards=n_shards, capacity=1024,
                           device="cpu")
    ref_dedup = RefIndex(Mesh(np.array(jax.devices()), ("data",)), ref_host,
                         capacity=1024)
    ref_be = RefCpuBackend(RefParams.from_desired(4096))

    out, hints = gpu.manifest_many_classified(streams, dedup)
    ref_out, ref_hints = ref_be.manifest_many_classified(streams, ref_dedup)
    assert _as_tuples(out) == _as_tuples(ref_out)
    assert hints == ref_hints
    hashes = [r.hash for refs in out for r in refs]
    assert len(hints) == len(hashes)
    # the host oracle: first occurrence new, every repeat a duplicate
    seen = set()
    assert hints == [h in seen or seen.add(h) is not None for h in hashes]
    assert sum(hints) > 10
    if overflow == "candidates":
        assert pipe.oracle_reruns == 2 and pipe.pool_reruns == 0
    else:
        assert pipe.pool_reruns == 1 and pipe.oracle_reruns == 0

    # the packer would now queue every blob: a second pass is all dups
    for h in hashes:
        host.mark_queued(h)
        ref_host.mark_queued(h)
    out2, hints2 = gpu.manifest_many_classified(streams, dedup)
    assert _as_tuples(out2) == _as_tuples(out)
    assert all(hints2)
    assert hints2 == ref_be.manifest_many_classified(streams, ref_dedup)[1]


def test_device_flags_classify_batched_rows(tmp_path):
    """Rows of a batch that neither overflowed nor lost a lane carry
    concrete device flags; tiny, empty and long streams carry none."""
    params = CDCParams.from_desired(4096)
    streams = _corpus()
    pipe = GpuBackend(params, device="cpu").pipeline
    pipe.scanner.segment_size = SEGMENT
    dedup = MeshDedupIndex(_authorities(tmp_path)[0], capacity=1024,
                           device="cpu")
    windows = []
    dedup.note_window = lambda n_real, n_lost: windows.append(
        (n_real, n_lost))
    out, flags = pipe.manifest_batch_classified(streams, dedup)
    assert [f is None for f in flags] == [False] * 7 + [True] * 5
    # every occurrence in one batch reports the pre-batch state: a and
    # its repeat share the 128 KiB batch
    assert not flags[0].any() and not flags[2].any()
    # the 64 KiB batch ran first, so its chunks are resident for row 4
    small = {d.tobytes() for d in out[5][1]}
    assert flags[4].tolist() == [d.tobytes() in small for d in out[4][1]]
    assert flags[4].any() and not flags[5].any() and not flags[6].any()
    n_chunks = sum(len(out[i][0]) for i in range(7))
    assert sorted(windows) == sorted([(sum(len(out[i][0]) for i in (5, 6)),
                                       0),
                                      (n_chunks - sum(len(out[i][0])
                                                      for i in (5, 6)), 0)])


def test_falls_back_to_two_passes_without_a_device_handoff():
    class HostOnly:
        def __init__(self):
            self.seen = set()

        def classify_insert(self, hashes):
            return [h in self.seen or self.seen.add(h) is not None
                    for h in hashes]

    params = CDCParams.from_desired(4096)
    streams = _corpus()[:3]
    gpu = GpuBackend(params, device="cpu")
    out, hints = gpu.manifest_many_classified(streams, HostOnly())
    assert _as_tuples(out) == _as_tuples(gpu.manifest_many(streams))
    n = len(out[0])
    assert hints[:n] == [False] * n and hints[-n:] == [True] * n


def test_dedup_table_from_reference_probes_alike():
    mesh = Mesh(np.array(jax.devices()), ("data",))
    r = ref_index.ShardedDedupIndex.create(mesh, capacity=64)
    rng = np.random.default_rng(17)
    hs = [rng.bytes(32) for _ in range(200)]
    q = hashes_to_queries(hs)
    r.insert(q[:150], np.arange(150, dtype=np.uint32) * 3)
    p = carry.dedup_table_from_reference(np.asarray(r.keys),
                                         np.asarray(r.values),
                                         max_probes=r.max_probes,
                                         device="cpu")
    assert (p.n_shards, p.capacity) == (8, 64)
    assert np.array_equal(p.probe(q), r.probe(q))
    assert (p.probe(q[150:]) == 0).all()
    assert p.keys.dtype == torch.int32
    with pytest.raises(ValueError):
        carry.dedup_table_from_reference(np.zeros((2, 8, 3)),
                                         np.zeros((2, 8)), max_probes=4)
