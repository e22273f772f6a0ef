"""The port's tiered dedup front and cold store vs the JAX package's: the
cases of ``tests/test_dedupstore.py``, each run through both packages.

The port's front has 8 shards on the CPU (plain versions of K5), the
reference's the 8-device CPU mesh; PR 2's tests showed the two table
layouts agree.  Each front gets its own package's ``BlobIndex`` as the
authority, fed alike.  Tolerance 0: flags, whole hot tables (and their
dumps), recency order, heat counters, tier counters and the bytes of
every cold run file (the demoted sets) must be equal, and each package
opens the other's cold directory.
"""

import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from backuwup_tpu.crypto import KeyManager as RefKeyManager
from backuwup_tpu.dedupstore import ColdFingerprintStore as RefCold
from backuwup_tpu.dedupstore import TieredDedupIndex as RefTiered
from backuwup_tpu.dedupstore.cold import pack_keys as ref_pack_keys
from backuwup_tpu.dedupstore.cold import unpack_keys as ref_unpack_keys
from backuwup_tpu.obs import metrics as ref_metrics
from backuwup_tpu.ops.dedup_index import hashes_to_queries as ref_queries
from backuwup_tpu.snapshot.blob_index import BlobIndex as RefBlobIndex
from backuwup_tpu.utils import faults as ref_faults
from backuwup_tpu_torch import carry
from backuwup_tpu_torch.crypto import KeyManager
from backuwup_tpu_torch.dedupstore import ColdFingerprintStore, TieredDedupIndex
from backuwup_tpu_torch.dedupstore.cold import pack_keys, unpack_keys
from backuwup_tpu_torch.obs import metrics as obs_metrics
from backuwup_tpu_torch.ops.dedup_index import hashes_to_queries
from backuwup_tpu_torch.snapshot.blob_index import BlobIndex
from backuwup_tpu_torch.utils import faults

pytestmark = pytest.mark.tiered

TIER_SITES = {
    "tier.run.commit.pre", "tier.run.commit.post",
    "tier.compact.commit.pre", "tier.compact.commit.post",
}
SHARDS = 8
BUDGET = SHARDS * 64 * 20  # 512 hot slots in all


@pytest.fixture(autouse=True)
def _isolate():
    for reg in (obs_metrics, ref_metrics):
        reg.registry().reset()
    yield
    for reg in (obs_metrics, ref_metrics):
        reg.registry().reset()
    faults.uninstall()
    ref_faults.uninstall()


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:SHARDS]), ("data",))


@pytest.fixture
def hosts(tmp_path):
    return (BlobIndex(KeyManager.from_secret(b"\x07" * 32),
                      tmp_path / "index_port"),
            RefBlobIndex(RefKeyManager.from_secret(b"\x07" * 32),
                         tmp_path / "index_ref"))


def _queries(n, seed=0):
    return np.random.default_rng(seed).integers(1, 2 ** 32, (n, 4),
                                                dtype=np.uint32)


def _hashes(n, seed=0):
    rng = np.random.default_rng(seed)
    return [t.tobytes()
            for t in rng.integers(0, 256, (n, 32), dtype=np.uint8)]


def _metric(name, **labels):
    """The metric in both registries; they must agree."""
    got = []
    for reg in (obs_metrics, ref_metrics):
        m = reg.registry().get(name)
        got.append(0 if m is None else m.value(**labels))
    assert got[0] == got[1], (name, labels, got)
    return got[0]


def _runs(root):
    return {p.name: p.read_bytes() for p in sorted(Path(root).glob("r*.run"))}


def _same_cold(port, ref):
    assert _runs(port.root) == _runs(ref.root)
    assert port._memtable == ref._memtable
    assert (len(port), port.run_count) == (len(ref), ref.run_count)


def _same_front(port, ref):
    assert port.capacity == ref.capacity
    assert port.hbm_table_bytes == ref.hbm_table_bytes
    assert np.array_equal(port.sharded.keys.numpy().view(np.uint32),
                          np.asarray(ref.sharded.keys))
    assert np.array_equal(port.sharded.values.numpy().view(np.uint32),
                          np.asarray(ref.sharded.values))
    for a, b in zip(port.sharded.dump(), ref.sharded.dump()):
        assert np.array_equal(a, b)
    assert list(port._recent) == list(ref._recent)
    assert port._cold_hits == ref._cold_hits
    assert port._promote_queue == ref._promote_queue
    assert port._windows == ref._windows
    _same_cold(port.cold, ref.cold)


def _fronts(mesh, hosts, tmp_path, **kw):
    kw.setdefault("hbm_budget_bytes", BUDGET)
    return (TieredDedupIndex(hosts[0], n_shards=SHARDS, device="cpu",
                             cold_dir=tmp_path / "cold_port", **kw),
            RefTiered(mesh, hosts[1], cold_dir=tmp_path / "cold_ref", **kw))


def _classify_both(fronts, hosts, batch, mark=True):
    flags = fronts[0].classify_insert(batch)
    assert flags == fronts[1].classify_insert(batch)
    if mark:
        for h in batch:
            for host in hosts:
                host.mark_queued(h)
    return flags


def _resolve_both(fronts, hashes, raw):
    flags = fronts[0].resolve_hints(hashes, raw)
    assert flags == fronts[1].resolve_hints(hashes, raw)
    return flags


def _probe(front, hashes):
    return front.sharded.probe(hashes_to_queries(hashes))


# --- key packing ------------------------------------------------------------


def test_pack_unpack_roundtrip_and_order():
    q = _queries(4096, seed=3)
    q[:17, 3] = 0
    q[5, :] = [1, 0, 0, 0]
    packed = pack_keys(q)
    assert packed.dtype == np.dtype("S16")
    assert packed.tobytes() == ref_pack_keys(q).tobytes()
    back = unpack_keys(packed)
    assert np.array_equal(back, q)
    assert np.array_equal(back, ref_unpack_keys(ref_pack_keys(q)))
    srt = np.sort(packed)
    lex = np.lexsort((q[:, 3], q[:, 2], q[:, 1], q[:, 0]))
    assert np.array_equal(unpack_keys(srt), q[lex])


# --- cold store units -------------------------------------------------------


def _stores(tmp_path, **kw):
    return ColdFingerprintStore(tmp_path / "port", **kw), \
        RefCold(tmp_path / "ref", **kw)


def _classify_stores(stores, q):
    got = stores[0].classify(q)
    assert np.array_equal(got, stores[1].classify(q))
    return got


def test_cold_memtable_classify_and_padding(tmp_path):
    stores = _stores(tmp_path)
    q = _queries(64, seed=1)
    for s in stores:
        s.insert(q, np.arange(64, dtype=np.uint32))
    assert np.array_equal(_classify_stores(stores, q),
                          np.arange(64, dtype=np.uint32) + 1)
    padded = np.vstack([np.zeros((2, 4), dtype=np.uint32), q[:3]])
    assert np.array_equal(_classify_stores(stores, padded)[:2], [0, 0])
    for s in stores:
        s.insert(np.zeros((5, 4), dtype=np.uint32))
    assert _classify_stores(stores, np.zeros((1, 4), dtype=np.uint32))[0] == 0
    assert (_classify_stores(stores, _queries(16, seed=2)) == 0).all()
    _same_cold(*stores)


def test_cold_flush_reopen_durable(tmp_path):
    stores = _stores(tmp_path)
    q = _queries(300, seed=4)
    for s in stores:
        s.insert(q)
        s.flush()
    assert stores[0].run_count == 1
    _same_cold(*stores)
    # each package reopens the other's directory
    for again in (ColdFingerprintStore(tmp_path / "ref"),
                  RefCold(tmp_path / "port")):
        assert (again.classify(q) != 0).all()
        assert len(again) == 300


def test_cold_newest_value_wins(tmp_path):
    stores = _stores(tmp_path, compact_fanin=64)
    q = _queries(10, seed=5)
    for s in stores:
        s.insert(q, np.full(10, 7, dtype=np.uint32))
        s.flush()
        s.insert(q[:4], np.full(4, 9, dtype=np.uint32))
    assert (_classify_stores(stores, q[:4]) == 10).all()
    for s in stores:
        s.flush()
    assert (_classify_stores(stores, q[:4]) == 10).all()
    assert (_classify_stores(stores, q[4:]) == 8).all()
    _same_cold(*stores)


def test_cold_compaction_folds_same_size_runs(tmp_path):
    stores = _stores(tmp_path, compact_fanin=3)
    qs = [_queries(50, seed=10 + i) for i in range(6)]
    for q in qs:
        for s in stores:
            s.insert(q)
            s.flush()
        _same_cold(*stores)
    assert stores[0].run_count < 6
    for q in qs:
        assert (_classify_stores(stores, q) != 0).all()
    for again in (ColdFingerprintStore(tmp_path / "ref"),
                  RefCold(tmp_path / "port")):
        for q in qs:
            assert (again.classify(q) != 0).all()


def test_cold_reset_drops_everything(tmp_path):
    stores = _stores(tmp_path)
    q = _queries(40, seed=6)
    for s in stores:
        s.insert(q)
        s.flush()
        s.insert(_queries(8, seed=7))
        s.reset()
    assert stores[0].run_count == 0 and len(stores[0]) == 0
    assert (_classify_stores(stores, q) == 0).all()
    assert not list((tmp_path / "port").glob("r*.run"))
    _same_cold(*stores)
    # seqs stay monotonic after a reset, alike in both
    for s in stores:
        s.insert(q)
        s.flush()
    _same_cold(*stores)


def test_cold_recovery_drops_tmp_leftovers(tmp_path):
    stores = _stores(tmp_path)
    for s in stores:
        s.insert(_queries(20, seed=8))
        s.flush()
        (s.root / "r999999999999.tmp").write_bytes(b"partial run image")
    port = ColdFingerprintStore(tmp_path / "port")
    ref = RefCold(tmp_path / "ref")
    for name in ("port", "ref"):
        assert not (tmp_path / name / "r999999999999.tmp").exists()
    assert port.run_count == ref.run_count == 1
    _same_cold(port, ref)


# --- crash seams ------------------------------------------------------------


def test_tier_crash_sites_registered():
    """The port's crash sites are exactly these, whatever other test files
    ran before this one in the same process: every module of either
    package that registers one is imported here, so the registry holds
    all of them, and the registrations in the port's sources are the
    set below."""
    import importlib
    import re

    for pkg in ("backuwup_tpu", "backuwup_tpu_torch"):
        for mod in ("dedupstore.cold", "snapshot.packfile",
                    "snapshot.blob_index", "net.serverstore", "net.p2p",
                    "engine"):
            importlib.import_module(f"{pkg}.{mod}")
    want = TIER_SITES | {
        "pack.seal.pre", "pack.seal.post", "index.save.pre",
        "index.save.post", "challenge.save.pre", "challenge.save.post",
        "partial.sink.pre", "partial.sink.post",
        "repl.log.append.pre", "repl.log.append.post", "repl.ship.acked",
        "repl.promote.pre", "repl.promote.post"} | {
        f"{seam}.{side}" for side in ("pre", "post") for seam in (
            "placement.insert", "stripe.finish", "repair.rehome",
            "gc.prune", "gc.sweep", "gc.compact.seal", "gc.swap",
            "gc.reclaim")}
    sites = set(faults.crash_sites())
    assert sites == want
    port = Path(faults.__file__).resolve().parent.parent
    found = {m for f in port.rglob("*.py") for m in re.findall(
        r'register_crash_site\(\s*"([^"]+)"', f.read_text())}
    assert found == want
    # the port registers the reference's names for the seams it has
    assert sites <= set(ref_faults.crash_sites())


def _crash_flush(pkg_faults, store, site):
    plane = pkg_faults.install(pkg_faults.FaultPlane(seed=1))
    plane.arm_crash(site)
    with pytest.raises(pkg_faults.CrashInjected):
        store.flush()
    pkg_faults.uninstall()


@pytest.mark.crash
@pytest.mark.parametrize("site", ["tier.run.commit.pre",
                                  "tier.run.commit.post"])
def test_crash_around_run_commit_recovers(tmp_path, site):
    stores = _stores(tmp_path)
    q = _queries(100, seed=20)
    for pkg, s in zip((faults, ref_faults), stores):
        s.insert(q)
        _crash_flush(pkg, s, site)
    port = ColdFingerprintStore(tmp_path / "port")
    ref = RefCold(tmp_path / "ref")
    for name in ("port", "ref"):
        assert not list((tmp_path / name).glob("*.tmp"))
    _same_cold(port, ref)
    if site.endswith(".pre"):
        assert port.run_count == 0
        assert (_classify_stores((port, ref), q) == 0).all()
    else:
        assert port.run_count == 1
        assert (_classify_stores((port, ref), q) != 0).all()


@pytest.mark.crash
@pytest.mark.parametrize("site", ["tier.compact.commit.pre",
                                  "tier.compact.commit.post"])
def test_crash_around_compaction_recovers(tmp_path, site):
    stores = _stores(tmp_path, compact_fanin=3)
    qs = [_queries(50, seed=30 + i) for i in range(2)]
    q3 = _queries(50, seed=32)
    for pkg, s in zip((faults, ref_faults), stores):
        for q in qs:
            s.insert(q)
            s.flush()
        assert s.run_count == 2
        s.insert(q3)
        _crash_flush(pkg, s, site)
    port = ColdFingerprintStore(tmp_path / "port")
    ref = RefCold(tmp_path / "ref")
    _same_cold(port, ref)
    assert port.run_count == (3 if site.endswith(".pre") else 1)
    for q in qs + [q3]:
        assert (_classify_stores((port, ref), q) != 0).all()


# --- tiered front -----------------------------------------------------------


def test_budget_is_hard_cap_with_demotion(mesh, hosts, tmp_path):
    fronts = _fronts(mesh, hosts, tmp_path, memtable_limit=256)
    hs = _hashes(5000, seed=40)
    for s in range(0, len(hs), 500):
        batch = hs[s:s + 500]
        flags = fronts[0].classify_insert(batch)
        assert flags == fronts[1].classify_insert(batch)
        for h, f in zip(batch, flags):
            assert f == hosts[0].is_duplicate(h)
            for host in hosts:
                host.mark_queued(h)
        assert fronts[0].hbm_table_bytes <= BUDGET
        _same_front(*fronts)
    assert _metric("bkw_tier_demotions_total") > 0
    assert _metric("bkw_tier_hbm_highwater_bytes") <= BUDGET
    rng = np.random.default_rng(41)
    sample = [hs[i] for i in rng.integers(0, len(hs), 1000)]
    assert all(_classify_both(fronts, hosts, sample, mark=False))
    assert not any(_classify_both(fronts, hosts, _hashes(200, seed=42),
                                  mark=False))
    _same_front(*fronts)


def test_promotion_clock_repins_hot_cold_keys(mesh, hosts, tmp_path):
    fronts = _fronts(mesh, hosts, tmp_path, memtable_limit=256,
                     clock_windows=1, promote_min_hits=1)
    hs = _hashes(4000, seed=50)
    for s in range(0, len(hs), 500):
        _classify_both(fronts, hosts, hs[s:s + 500])
    port, ref = fronts
    # keys demoted out of HBM: the cold tier answers, the hot table not
    q = hashes_to_queries(hs)
    cold_only = (port.sharded.probe(q) == 0) & (port.cold.classify(q) != 0)
    rq = ref_queries(hs)
    assert np.array_equal(cold_only, (ref.sharded.probe(rq) == 0)
                          & (ref.cold.classify(rq) != 0))
    demoted = [hs[i] for i in np.flatnonzero(cold_only)[:32]]
    assert demoted, "expected demoted keys at ~8x budget"
    before = _metric("bkw_tier_promotions_total")
    assert all(_resolve_both(fronts, demoted, [False] * len(demoted)))
    assert _metric("bkw_tier_promotions_total") > before
    assert (_probe(port, demoted) != 0).all()
    assert port.hbm_table_bytes <= BUDGET
    _same_front(port, ref)
    d0 = _metric("bkw_tier_probes_total", path="device")
    h0 = _metric("bkw_tier_hits_total", path="device")
    flags = [bool(f) for f in _probe(port, demoted) != 0]
    assert all(_resolve_both(fronts, demoted, flags))
    d1 = _metric("bkw_tier_probes_total", path="device")
    h1 = _metric("bkw_tier_hits_total", path="device")
    assert d1 - d0 >= len(demoted)
    assert (h1 - h0) / (d1 - d0) > 0.95
    _same_front(port, ref)


def test_resolve_hints_cold_fallthrough(mesh, hosts, tmp_path):
    fronts = _fronts(mesh, hosts, tmp_path, memtable_limit=256)
    hs = _hashes(4000, seed=60)
    for s in range(0, len(hs), 500):
        _classify_both(fronts, hosts, hs[s:s + 500])
    cold = fronts[0].cold.classify(hashes_to_queries(hs[:512])) != 0
    demoted = [hs[i] for i in np.flatnonzero(cold)[:16]]
    assert demoted, "expected some demoted keys at 10x budget"
    assert all(_resolve_both(fronts, demoted, [False] * len(demoted)))
    fresh = _hashes(4, seed=61)
    assert _resolve_both(fronts, fresh, [False] * 4) == [False] * 4
    q = _hashes(2, seed=62)
    for host in hosts:
        host.mark_queued(q[0])
    assert _resolve_both(fronts, q, [None, None]) == [True, False]
    _same_front(*fronts)


def test_restart_seeds_from_cold_runs(mesh, hosts, tmp_path):
    fronts = _fronts(mesh, hosts, tmp_path, memtable_limit=256)
    hs = _hashes(3000, seed=70)
    for s in range(0, len(hs), 500):
        _classify_both(fronts, hosts, hs[s:s + 500])
    for f in fronts:
        f.cold.flush()
    runs = fronts[0].cold.run_count
    assert runs > 0
    _same_front(*fronts)
    # restart each package on the OTHER package's cold directory (a copy,
    # so the two restarted fronts do not share files)
    shutil.copytree(tmp_path / "cold_ref", tmp_path / "cold_port2")
    shutil.copytree(tmp_path / "cold_port", tmp_path / "cold_ref2")
    again = (TieredDedupIndex(hosts[0], n_shards=SHARDS, device="cpu",
                              cold_dir=tmp_path / "cold_port2",
                              hbm_budget_bytes=BUDGET, memtable_limit=256),
             RefTiered(mesh, hosts[1], cold_dir=tmp_path / "cold_ref2",
                       hbm_budget_bytes=BUDGET, memtable_limit=256))
    assert again[0].cold.run_count >= runs
    _same_front(*again)
    assert all(_classify_both(again, hosts, hs, mark=False))
    assert again[0].hbm_table_bytes <= BUDGET
    _same_front(*again)


def test_reconcile_wipes_stale_cold_keys(mesh, tmp_path):
    hs = _hashes(3000, seed=80)
    hosts = (BlobIndex(KeyManager.from_secret(b"\x07" * 32),
                       tmp_path / "index_port"),
             RefBlobIndex(RefKeyManager.from_secret(b"\x07" * 32),
                          tmp_path / "index_ref"))
    for host in hosts:
        for h in hs:
            host.mark_queued(h)
    fronts = _fronts(mesh, hosts, tmp_path, memtable_limit=256)
    for f in fronts:
        f.cold.flush()
    assert len(fronts[0].cold) > 0
    _same_front(*fronts)
    pruned, kept = hs[:1500], hs[1500:]
    hosts2 = (BlobIndex(KeyManager.from_secret(b"\x07" * 32),
                        tmp_path / "index_port2"),
              RefBlobIndex(RefKeyManager.from_secret(b"\x07" * 32),
                           tmp_path / "index_ref2"))
    for host in hosts2:
        for h in kept:
            host.mark_queued(h)
    fronts2 = _fronts(mesh, hosts2, tmp_path, memtable_limit=256)
    assert not any(_classify_both(fronts2, hosts2, pruned[:300], mark=False))
    assert all(_classify_both(fronts2, hosts2, kept[:300], mark=False))
    _same_front(*fronts2)


def test_carry_reference_front_mid_run(mesh, hosts, tmp_path):
    """``carry.tiered_from_reference`` mid-run: after demotions, a port
    front built from the reference's state (its cold runs copied, its
    memtable carried) classifies the next batches as the reference does
    and ends in the same state."""
    ref = RefTiered(mesh, hosts[1], cold_dir=tmp_path / "cold_ref",
                    hbm_budget_bytes=BUDGET, memtable_limit=256)
    hs = _hashes(6000, seed=85)
    for s in range(0, 3000, 500):
        ref.classify_insert(hs[s:s + 500])
        for h in hs[s:s + 500]:
            for host in hosts:
                host.mark_queued(h)
    assert _metric_ref("bkw_tier_demotions_total") > 0
    shutil.copytree(tmp_path / "cold_ref", tmp_path / "cold_port")
    port = carry.tiered_from_reference(ref, hosts[0], tmp_path / "cold_port",
                                       device="cpu")
    _same_front(port, ref)
    for s in range(3000, 6000, 500):
        _classify_both((port, ref), hosts, hs[s:s + 500])
        _same_front(port, ref)
    assert all(_classify_both((port, ref), hosts, hs[::7], mark=False))


def _metric_ref(name, **labels):
    m = ref_metrics.registry().get(name)
    return 0 if m is None else m.value(**labels)


@pytest.mark.timeout(600)
def test_parity_oracle_1e6_under_budget(mesh, hosts, tmp_path):
    """The acceptance gate through both packages: classification equal to
    the BlobIndex oracle and to the reference at 1e6 fingerprints, ~15x
    the hot slots, the table never over the budget; the final states
    (tables, recency, cold runs) equal."""
    n = 1_000_000
    budget = SHARDS * 8192 * 20
    fronts = _fronts(mesh, hosts, tmp_path, hbm_budget_bytes=budget)
    rng = np.random.default_rng(90)
    hashes = [t.tobytes()
              for t in rng.integers(0, 256, (n, 32), dtype=np.uint8)]
    mismatches = 0
    for s in range(0, n, 8192):
        batch = hashes[s:s + 8192]
        flags = fronts[0].classify_insert(batch)
        assert flags == fronts[1].classify_insert(batch)
        for h, f in zip(batch, flags):
            if f != hosts[0].is_duplicate(h):
                mismatches += 1
            for host in hosts:
                host.mark_queued(h)
        assert fronts[0].hbm_table_bytes <= budget
    assert mismatches == 0
    assert _metric("bkw_tier_hbm_highwater_bytes") <= budget
    assert _metric("bkw_tier_demotions_total") > 0
    _same_front(*fronts)
    sample = [hashes[i] for i in rng.integers(0, n, 20000)]
    assert all(_classify_both(fronts, hosts, sample, mark=False))
    fresh = [t.tobytes()
             for t in rng.integers(0, 256, (2000, 32), dtype=np.uint8)]
    assert not any(_classify_both(fronts, hosts, fresh, mark=False))
    _same_front(*fronts)
