"""The port's ShardedDedupIndex (plain versions on the CPU) vs the JAX
``ShardedDedupIndex`` on a 1-device and an 8-device CPU mesh.

The cases of ``tests/test_dedup_index.py``, each at ``n_shards`` 1 and 8
against the JAX table on a mesh of as many devices.  Tolerance 0: ``found``,
``lost`` and the raw ``keys``/``values`` layout (through
``view(np.uint32)``) must be equal after every insert and after
``grown()``; the tie rule (highest query index wins a contested slot) is
what makes the layouts match.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from backuwup_tpu.ops import dedup_index as ref
from backuwup_tpu.ops.blake3_cpu import blake3_hash
from backuwup_tpu_torch.ops import dedup_index as port

SHARDS = [1, 8]


@pytest.fixture(scope="module")
def meshes():
    devs = jax.devices()
    return {d: jax.sharding.Mesh(np.array(devs[:d]), ("data",))
            for d in SHARDS}


def _pair(meshes, d, capacity, **kw):
    return (port.ShardedDedupIndex.create(d, capacity=capacity,
                                          device="cpu", **kw),
            ref.ShardedDedupIndex.create(meshes[d], capacity=capacity, **kw))


def _same_layout(p, r):
    assert np.array_equal(p.keys.numpy().view(np.uint32), np.asarray(r.keys))
    assert np.array_equal(p.values.numpy().view(np.uint32),
                          np.asarray(r.values))


def _hashes(n, seed=0):
    return [blake3_hash(f"{seed}:{i}".encode()) for i in range(n)]


def _insert_both(p, r, q, vals):
    got = p.insert(q, vals)
    want = r.insert(q, vals)
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    _same_layout(p, r)
    return got


@pytest.mark.parametrize("d", SHARDS)
def test_probe_empty_table(meshes, d):
    p, r = _pair(meshes, d, 1024 // d)
    q = port.hashes_to_queries(_hashes(10))
    assert (p.probe(q) == 0).all()
    assert np.array_equal(p.probe(q), r.probe(q))


@pytest.mark.parametrize("d", SHARDS)
def test_insert_then_probe(meshes, d):
    p, r = _pair(meshes, d, 1024 // d)
    q = port.hashes_to_queries(_hashes(100))
    vals = np.arange(100, dtype=np.uint32)
    assert (_insert_both(p, r, q, vals) == 0).all()
    assert (p.probe(q) == vals + 1).all()
    assert np.array_equal(p.probe(q), r.probe(q))
    unseen = port.hashes_to_queries(_hashes(50, seed=9))
    assert (p.probe(unseen) == 0).all()


@pytest.mark.parametrize("d", SHARDS)
def test_reinsert_keeps_original_value(meshes, d):
    p, r = _pair(meshes, d, 1024 // d)
    q = port.hashes_to_queries(_hashes(20))
    _insert_both(p, r, q, np.full(20, 5, dtype=np.uint32))
    assert (_insert_both(p, r, q, np.full(20, 9, dtype=np.uint32)) == 6).all()
    assert (p.probe(q) == 6).all()


@pytest.mark.parametrize("d", SHARDS)
def test_matches_host_index_classification(meshes, d):
    p, r = _pair(meshes, d, 4096 // d)
    host = {}
    rng = np.random.default_rng(3)
    for batch in range(5):
        hs = []
        for i in range(200):
            if host and rng.random() < 0.4:
                hs.append(list(host)[int(rng.integers(len(host)))])
            else:
                hs.append(blake3_hash(f"b{batch}i{i}".encode()))
        seen = set()
        uniq = [h for h in hs if not (h in seen or seen.add(h))]
        found = _insert_both(p, r, port.hashes_to_queries(uniq),
                             np.arange(len(uniq), dtype=np.uint32))
        for h, f in zip(uniq, found):
            assert (f > 0) == (h in host)
            host[h] = True


@pytest.mark.parametrize("d", SHARDS)
def test_probe_exhaustion_raises_not_silently_drops(meshes, d):
    p, r = _pair(meshes, d, 64 // d, max_probes=8)
    q = port.hashes_to_queries(_hashes(512, seed=11))
    vals = np.arange(512, dtype=np.uint32)
    with pytest.raises(port.DedupIndexFull):
        p.insert(q, vals)
    with pytest.raises(ref.DedupIndexFull):
        r.insert(q, vals)
    # the failed attempt leaves the same partial table on both
    _same_layout(p, r)


@pytest.mark.parametrize("d", SHARDS)
def test_capacity_pressure_linear_probing(meshes, d):
    p, r = _pair(meshes, d, 512 // d, max_probes=64)
    q = port.hashes_to_queries(_hashes(256, seed=4))
    assert (_insert_both(p, r, q, np.arange(256, dtype=np.uint32)) == 0).all()
    assert (p.probe(q) > 0).all()


@pytest.mark.parametrize("d", SHARDS)
def test_zero_query_rows_are_padding_for_probe_and_insert(meshes, d):
    p, r = _pair(meshes, d, 512 // d)
    q = port.hashes_to_queries(_hashes(6, seed=21))
    padded = np.vstack([q[:3], np.zeros((2, 4), dtype=np.uint32), q[3:]])
    assert (_insert_both(p, r, padded, np.arange(8, dtype=np.uint32))
            == 0).all()
    assert (p.probe(q) > 0).all()
    assert (p.probe(np.zeros((4, 4), dtype=np.uint32)) == 0).all()
    again = p.probe(padded)
    assert (again[3:5] == 0).all() and (again[:3] > 0).all()
    assert int((p.keys != 0).any(dim=2).sum()) == 6


@pytest.mark.parametrize("d", SHARDS)
def test_intra_batch_duplicate_fingerprints_single_resident(meshes, d):
    p, r = _pair(meshes, d, 512 // d)
    h = _hashes(1, seed=22)[0]
    q = port.hashes_to_queries([h, h, h])
    assert (_insert_both(p, r, q, np.array([4, 9, 13], dtype=np.uint32))
            == 0).all()
    # the highest query index wins, as the last XLA scatter update does
    assert int(p.probe(q[:1])[0]) == 14
    assert int(_insert_both(p, r, q[:1], np.array([77], dtype=np.uint32))[0]) \
        == 14


@pytest.mark.parametrize("d", SHARDS)
def test_races_past_the_retry_rounds_match(meshes, d):
    """64 distinct keys share one shard and one start slot: each round
    places one, so after the first round and 10 retries 53 lanes still
    report LOST_RACE, and the host loop finishes them; found, lost and
    the layout match the JAX program round for round."""
    cap = 256
    p, r = _pair(meshes, d, cap, max_probes=128)
    rng = np.random.default_rng(31)
    q = rng.integers(1, 2**32, (64, 4), dtype=np.uint64).astype(np.uint32)
    q[:, 0] = q[:, 0] // d * d + 3 % d  # one owner shard
    q[:, 1] = (q[:, 1] // cap) * cap + 200  # one start slot
    q = np.vstack([q, q[:5]])  # repeats of racing keys in the same batch
    vals = np.arange(len(q), dtype=np.uint32) + 1000
    found, lost = p._insert_once(q, vals)
    f_ref, l_ref = r._insert_once(q, vals)
    assert np.array_equal(found, f_ref) and np.array_equal(lost, l_ref)
    assert int((lost == port.LOST_RACE).sum()) >= 53
    _same_layout(p, r)
    _insert_both(p, r, q, vals)
    assert (p.probe(q) > 0).all()


@pytest.mark.parametrize("racing", [1, 2, 5])
@pytest.mark.parametrize("d", SHARDS)
def test_races_for_exact_rounds_match(meshes, d, racing):
    """``racing + 1`` distinct keys share one shard and one start slot,
    beside keys on other start slots: each round places the highest
    racing index, so lanes race in exactly ``racing`` rounds and none is
    lost; found, lost and the layout match the JAX program."""
    cap = 256
    p, r = _pair(meshes, d, cap, max_probes=64)
    rng = np.random.default_rng(40 + racing)
    q = rng.integers(1, 2**32, (racing + 1 + 40, 4),
                     dtype=np.uint64).astype(np.uint32)
    q[:, 0] = q[:, 0] // d * d + 3 % d  # one owner shard
    q[:, 1] = (q[:, 1] // cap) * cap + 200  # one start slot ...
    q[racing + 1:, 1] -= np.arange(40, dtype=np.uint32) * 3 + 80  # ... or not
    q = q[rng.permutation(len(q))]
    vals = np.arange(len(q), dtype=np.uint32) + 1000
    found, lost = p._insert_once(q, vals)
    f_ref, l_ref = r._insert_once(q, vals)
    assert np.array_equal(found, f_ref) and np.array_equal(lost, l_ref)
    assert not lost.any() and not found.any()
    _same_layout(p, r)
    # round j placed the highest racing index still racing in slot 200 + j
    racers = np.flatnonzero(q[:, 1] % cap == 200)[::-1]
    assert len(racers) == racing + 1
    slots = p.keys.numpy().view(np.uint32)[3 % d, 200:201 + racing]
    assert np.array_equal(slots, q[racers])
    assert not p.keys.numpy()[3 % d, 201 + racing].any()


@pytest.mark.parametrize("d", SHARDS)
def test_insert_device_and_probe_device(meshes, d):
    p, r = _pair(meshes, d, 512 // d)
    q = port.hashes_to_queries(_hashes(96, seed=5))
    q = np.vstack([q, q[:32]])  # intra-batch repeats
    q_dev = torch.from_numpy(q.view(np.int32))[None]
    v_dev = torch.arange(len(q), dtype=torch.int32)[None]
    found, lost = p.insert_device(q_dev, v_dev)
    assert found.shape == lost.shape == (1, len(q))
    qs, _ = ref._pad_queries(q, d)
    vs = jnp.asarray(np.arange(len(q), dtype=np.uint32).reshape(d, -1))
    f_ref, l_ref = r.insert_device(qs, vs)
    assert np.array_equal(found.numpy().view(np.uint32).reshape(-1),
                          np.asarray(f_ref).reshape(-1))
    assert np.array_equal(lost.numpy().view(np.uint32).reshape(-1),
                          np.asarray(l_ref).reshape(-1))
    _same_layout(p, r)
    got = p.probe_device(q_dev).numpy().view(np.uint32).reshape(-1)
    assert np.array_equal(got, np.asarray(r.probe_device(qs)).reshape(-1))


@pytest.mark.parametrize("d", SHARDS)
def test_grown_rehashes_like_the_reference(meshes, d):
    p, r = _pair(meshes, d, 256 // d, max_probes=64)
    q = port.hashes_to_queries(_hashes(128, seed=6))
    _insert_both(p, r, q, np.arange(128, dtype=np.uint32))
    p2, r2 = p.grown(1024 // d), r.grown(1024 // d)
    assert p2.capacity == 1024 // d
    _same_layout(p2, r2)
    assert np.array_equal(p2.probe(q), np.arange(128, dtype=np.uint32) + 1)
    more = port.hashes_to_queries(_hashes(64, seed=7))
    _insert_both(p2, r2, more, np.arange(64, dtype=np.uint32))
    with pytest.raises(ValueError):
        p2.grown(p2.capacity)
    keys, vals = p2.dump()
    rk, rv = r2.dump()
    assert np.array_equal(keys, rk) and np.array_equal(vals, rv)
    assert len(keys) == 192


def test_grown_migration_exhaustion_raises():
    # with one probe step, 60 keys cannot all land on their own start
    # slot of a 65-slot table
    p = port.ShardedDedupIndex.create(1, capacity=64, max_probes=64,
                                      device="cpu")
    p.insert(port.hashes_to_queries(_hashes(60, seed=8)),
             np.arange(60, dtype=np.uint32))
    small = port.ShardedDedupIndex(1, 64, p.keys, p.values, max_probes=1)
    with pytest.raises(port.DedupIndexFull):
        small.grown(65)


def test_hashes_to_queries_edge_rows():
    assert port.hashes_to_queries([]).shape == (0, port.KEY_WORDS)
    h = bytes(range(32))
    hs = [h, h[:16] + b"\xff" * 16, bytearray(h), memoryview(h)]
    assert np.array_equal(port.hashes_to_queries(hs),
                          ref.hashes_to_queries(hs))


def test_queries_from_cvs_matches_host_path():
    rng = np.random.default_rng(23)
    acc = rng.integers(0, 2**32, (16, 8), dtype=np.uint64).astype(np.uint32)
    acc[4] = 0
    acc[11] = 0
    q = port.queries_from_cvs(torch.from_numpy(acc.view(np.int32)))
    q = q.numpy().view(np.uint32)
    digests = [row.astype("<u4").tobytes() for row in acc]
    assert np.array_equal(q, port.hashes_to_queries(digests))
    assert np.array_equal(q, np.asarray(ref.queries_from_cvs(
        jnp.asarray(acc))))
    assert (q[4] == 0).all() and (q[11] == 0).all()


def test_found_wraps_like_u32():
    """A stored value of 0xFFFFFFFF reads back as found 0 (u32 wrap) on
    both, and the insert then rewrites its own slot."""
    p = port.ShardedDedupIndex.create(1, capacity=64, device="cpu")
    r = ref.ShardedDedupIndex.create(
        jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",)),
        capacity=64)
    q = port.hashes_to_queries(_hashes(4, seed=12))
    _insert_both(p, r, q, np.full(4, 0xFFFFFFFF, dtype=np.uint32))
    assert (p.probe(q) == 0).all()
    assert (_insert_both(p, r, q, np.arange(4, dtype=np.uint32)) == 0).all()
    assert np.array_equal(p.probe(q), np.arange(4, dtype=np.uint32) + 1)


@pytest.mark.parametrize("counts, rounds", [
    ([0] * 11, 1), ([5] + [0] * 10, 2), ([3, 2, 1] + [0] * 8, 4),
    ([9] * 11, 11)])
def test_insert_scratch_reads_rounds_and_grows(counts, rounds):
    """The insert kernel's scratch: round r + 1 ran only when lanes still
    raced after round r (the last round's count starts no round), and the
    per-lane buffers grow to the largest batch and never shrink."""
    s = port.InsertScratch(torch.device("cpu"))
    s.races.copy_(torch.tensor(counts, dtype=torch.int32))
    assert s.rounds_run() == rounds
    s.reserve(100)
    assert s.state.shape == (100,) and s.gslot.shape == (100,)
    s.reserve(10)
    assert s.state.shape == (100,) and s.gslot.dtype == torch.int64
