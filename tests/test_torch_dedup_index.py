"""The port's ShardedDedupIndex (plain versions on the CPU) vs the JAX
``ShardedDedupIndex`` on a 1-device and an 8-device CPU mesh.

The cases of ``tests/test_dedup_index.py``, each at ``n_shards`` 1 and 8
against the JAX table on a mesh of as many devices.  Tolerance 0: ``found``,
``lost`` and the raw ``keys``/``values`` layout (through
``view(np.uint32)``) must be equal after every insert and after
``grown()``; the tie rule (highest query index wins a contested slot) is
what makes the layouts match.
"""

import dataclasses

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


def _one_shard_keys(rng, n, d, cap, start):
    """``n`` distinct random keys of shard ``3 % d`` whose first slot in a
    table of ``cap`` slots is ``start``."""
    q = rng.integers(1, 2**32, (n, 4), dtype=np.uint64).astype(np.uint32)
    q[:, 0] = q[:, 0] // d * d + 3 % d
    q[:, 1] = (q[:, 1] // cap) * cap + start
    return q


@pytest.mark.parametrize("d", SHARDS)
def test_grown_race_heavy_matches_reference(meshes, d):
    """48 keys of one shard share their first slot in the old table and in
    the new one (200 of 256 and of 1024), beside keys elsewhere: every
    migration round places one of them, the highest old slot first, so
    the growth runs 48 rounds; the layouts match the JAX table's."""
    p, r = _pair(meshes, d, 256, max_probes=128)
    rng = np.random.default_rng(60)
    q = np.vstack([_one_shard_keys(rng, 48, d, 1024, 200),
                   port.hashes_to_queries(_hashes(60, seed=61))])
    vals = np.arange(len(q), dtype=np.uint32) + 7
    _insert_both(p, r, q, vals)
    nk = torch.zeros((d, 1024, 4), dtype=torch.int32)
    nv = torch.zeros((d, 1024), dtype=torch.int32)
    rounds, exhausted = port.migrate_round(
        p.keys.clone(), p.values.clone(), nk, nv,
        max_probes=p.max_probes).tolist()
    assert rounds == 48 and exhausted == 0
    p2, r2 = p.grown(1024), r.grown(1024)
    _same_layout(p2, r2)
    assert torch.equal(p2.keys, nk) and torch.equal(p2.values, nv)
    assert np.array_equal(p2.probe(q), vals + 1)
    assert np.array_equal(p2.probe(q), r2.probe(q))


@pytest.mark.parametrize("old_cap, new_cap", [(64, 100), (100, 250),
                                              (96, 128), (250, 1000)])
@pytest.mark.parametrize("d", SHARDS)
def test_grown_to_and_from_other_capacities(meshes, d, old_cap, new_cap):
    """Growths to and from capacities that are not powers of two, at load
    ~0.45 per shard: layouts, found and a probe of unseen keys match."""
    p, r = _pair(meshes, d, old_cap, max_probes=64)
    n = old_cap * d * 45 // 100
    q = port.hashes_to_queries(_hashes(n, seed=old_cap))
    _insert_both(p, r, q, np.arange(n, dtype=np.uint32))
    p2, r2 = p.grown(new_cap), r.grown(new_cap)
    assert p2.capacity == new_cap
    _same_layout(p2, r2)
    both = np.vstack([q, port.hashes_to_queries(_hashes(n, seed=7 + n))])
    got = p2.probe(both)
    assert np.array_equal(got, r2.probe(both))
    assert np.array_equal(got[:n], np.arange(n, dtype=np.uint32) + 1)
    assert not got[n:].any()


@pytest.mark.parametrize("d", SHARDS)
def test_grown_spans_many_probe_windows(meshes, d):
    """4,096 keys at load 0.5 grow 2x per shard (each shard's table spans
    many probe windows), then a probe of the keys and as many unseen."""
    cap = 8192 // d
    p, r = _pair(meshes, d, cap)
    q = port.hashes_to_queries(_hashes(4096, seed=62))
    vals = np.arange(4096, dtype=np.uint32) * 3
    _insert_both(p, r, q, vals)
    p2, r2 = p.grown(2 * cap), r.grown(2 * cap)
    _same_layout(p2, r2)
    both = np.vstack([q, port.hashes_to_queries(_hashes(4096, seed=63))])
    got = p2.probe(both)
    assert np.array_equal(got, r2.probe(both))
    assert np.array_equal(got[:4096], vals + 1) and not got[4096:].any()


@pytest.mark.parametrize("d", SHARDS)
def test_grown_exhaustion_matches_reference(meshes, d):
    """A growth whose walks are cut to one slot cannot place every key:
    both packages raise DedupIndexFull and keep the old table as it was."""
    p, r = _pair(meshes, d, 64, max_probes=64)
    q = np.vstack([_one_shard_keys(np.random.default_rng(64), 8, d, 65, 5),
                   port.hashes_to_queries(_hashes(40, seed=65))])
    _insert_both(p, r, q, np.arange(len(q), dtype=np.uint32))
    keys0, vals0 = p.keys.clone(), p.values.clone()
    with pytest.raises(port.DedupIndexFull):
        dataclasses.replace(p, max_probes=1).grown(65)
    with pytest.raises(ref.DedupIndexFull):
        dataclasses.replace(r, max_probes=1).grown(65)
    assert torch.equal(p.keys, keys0) and torch.equal(p.values, vals0)
    _same_layout(p, r)


@pytest.mark.parametrize("max_probes", [5, 33])
@pytest.mark.parametrize("d", SHARDS)
def test_probe_windows_wrap_at_the_shard_end(meshes, d, max_probes):
    """A run of 12 keys from the shard's third-last slot wraps to its
    start; probes of them, of unseen keys on the same first slot, of
    padding rows and of a key whose value is 0xFFFFFFFF (found 0) walk
    windows that wrap, with ``max_probes`` no multiple of a probe group."""
    cap = 64
    p, r = _pair(meshes, d, cap, max_probes=64)
    rng = np.random.default_rng(66 + max_probes)
    run = _one_shard_keys(rng, 12, d, cap, cap - 3)
    other = port.hashes_to_queries(_hashes(20, seed=67))
    vals = np.arange(32, dtype=np.uint32) + 100
    vals[5] = 0xFFFFFFFF
    _insert_both(p, r, np.vstack([run, other]), vals)
    unseen = _one_shard_keys(rng, 6, d, cap, cap - 3)
    q = np.vstack([run, np.zeros((3, 4), dtype=np.uint32), unseen, other])
    pm = dataclasses.replace(p, max_probes=max_probes)
    rm = dataclasses.replace(r, max_probes=max_probes)
    got = pm.probe(q)
    assert np.array_equal(got, rm.probe(q))
    assert got[5] == 0 and not got[12:21].any()
    reached = np.flatnonzero(got[:12])
    assert np.array_equal(got[reached], vals[reached] + 1)
    # 33 slots reach the whole run; 5 slots hold at most 5 of its keys
    assert len(reached) == 11 if max_probes == 33 else len(reached) <= 5


def _group_probe_model(keys, vals, q, group, align, max_probes):
    """numpy model of the group probe's addressing (``probe_kernel`` is
    ``group`` 4 without ``align``; ``scripts/torch_k5_variants.cu`` holds
    the others): lane g of a query's group holds walk position p = g - off
    (off = the start slot's place in its ``group``-aligned block of the
    whole table when ``align``, else 0; lanes with p < 0 take no part),
    each window advances p by ``group``, slots wrap at the end of the
    shard, and the lowest lane of the window's terminal ballot (lanes past
    ``max_probes`` masked off) ends the walk."""
    D, cap = keys.shape[:2]
    found = np.zeros(len(q), dtype=np.uint32)
    for i, key in enumerate(q):
        if not key.any():
            continue
        s, start = int(key[0]) % D, int(key[1]) % cap
        off = (s * cap + start) % group if align else 0
        for p0 in range(-off, max_probes, group):
            pos = [p0 + g for g in range(group)]
            slots = [keys[s, (start + p) % cap] if p >= 0 else None
                     for p in pos]
            term = [0 <= p < max_probes and (
                (k == key).all() or not k.any())
                for p, k in zip(pos, slots)]
            if any(term):
                p = pos[term.index(True)]
                if (keys[s, (start + p) % cap] == key).all():
                    v = int(vals[s, (start + p) % cap])
                    found[i] = np.uint32((v + 1) % 2**32)
                break
    return found


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("group", [4, 8])
@pytest.mark.parametrize("cap", [1, 3, 5, 8, 63, 64])
def test_probe_group_model_matches_plain(group, align, cap):
    """The group walk of the probe kernel and its trial variants (windows
    aligned in memory or from the start slot, wrap, ballot order, the
    ``max_probes`` mask) finds what the plain probe finds, on shards
    smaller and larger than a group, with runs that wrap."""
    rng = np.random.default_rng(cap * 10 + group)
    D = 2
    idx = port.ShardedDedupIndex.create(D, capacity=cap, max_probes=cap + 8,
                                        device="cpu")
    n = max(1, D * cap * 3 // 4)
    q = rng.integers(1, 2**32, (n, 4), dtype=np.uint64).astype(np.uint32)
    q[: n // 2, 1] = (q[: n // 2, 1] // cap) * cap + cap - 1
    vals = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    vals[0] = 0xFFFFFFFF
    idx.insert(q, vals)
    probe = np.vstack([q, np.zeros((2, 4), dtype=np.uint32),
                       rng.integers(1, 2**32, (n, 4),
                                    dtype=np.uint64).astype(np.uint32)])
    keys = idx.keys.numpy().view(np.uint32)
    tab = idx.values.numpy().view(np.uint32)
    for max_probes in (1, 3, 4, 5, 33):
        want = port.probe_table_plain(
            idx.keys, idx.values, torch.from_numpy(probe.view(np.int32)),
            max_probes=max_probes).numpy().view(np.uint32)
        got = _group_probe_model(keys, tab, probe, group, align, max_probes)
        assert np.array_equal(got, want), max_probes


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
