"""The port's backup engine vs the JAX package's.

The reference's own engine cases run through both packages: the non-slow
cases of ``tests/test_engine_send.py``, ``tests/test_transfer.py`` and
``tests/test_restore_swarm.py``, the engine cases of
``tests/test_erasure.py`` (the stripe geometry and the spread of a
storage grant over a stripe's peers) and of ``tests/test_audit.py`` (the
server-side block, the storage queue, the audit end to end and the
offline miss).  Each case is the reference test function re-created over
a namespace whose ``backuwup_tpu`` imports resolve in the package under
test (``rebind`` of ``tests/test_torch_net_server.py``), and so are the
fixtures of its module (:func:`run_ref`).  A case runs port against port
and reference against reference, and, when it starts a coordination
server, also with the engine (and its client side) of one package against
the server of the other.

The port's ``Engine(..., backend=None)`` would take the card
(``select_backend()``), so a case that builds one gets :class:`CpuEngine`,
which passes ``GpuBackend(device="cpu")``: the plain versions of the
kernels and the tiered dedup front on the CPU.  A case that uses
``ClientApp`` gets the port's (``backuwup_tpu_torch/app.py``), whose
engine takes the same backend when it is given none
(:func:`cpu_select_backend`).

On top of those, at tolerance 0 (:func:`test_engine_parity`): the port's
``Engine`` over ``GpuBackend(device="cpu")`` and the reference's over
``CpuBackend`` back up the same seeded tree with the same keys, over
holders and a server of either package, and give the same snapshot
roots, store rows, pack statistics, GC report and restored bytes.
"""

import asyncio
import hashlib
import inspect
import random
import time
import types
from dataclasses import asdict

import pytest

import test_audit as ref_audit
import test_engine_send as ref_engine_send
import test_erasure as ref_erasure
import test_restore_swarm as ref_restore_swarm
import test_transfer as ref_transfer
from backuwup_tpu_torch import engine as port_engine
from backuwup_tpu_torch.ops import backend as port_backend
from backuwup_tpu_torch.ops.backend import GpuBackend
from test_torch_net_server import (PORT, REF, cases, rebind, run_case,
                                   uses_any)
from test_torch_net_server import _isolate  # noqa: F401  (autouse)

# modules of the reference that the port does not have yet: a case that
# imports one takes the reference's
NOT_YET = ("scenario", "analysis", "sim")
SERVER_SIDE = ("net.server", "net.serverstore", "net.matchmaking",
               "net.ring")


def _not_yet(path: str) -> bool:
    return any(path == p or path.startswith(p + ".") for p in NOT_YET)


def pair(engine_pkg, server_pkg):
    """``pick`` for ``rebind``: the server side from ``server_pkg``, the
    engine and everything else from ``engine_pkg``."""
    def pick(path):
        if _not_yet(path):
            return REF
        return server_pkg if path in SERVER_SIDE else engine_pkg
    pick.engine_pkg = engine_pkg
    return pick


PAIRS = {"port": pair(PORT, PORT), "ref": pair(REF, REF),
         "port-engine-ref-server": pair(PORT, REF),
         "ref-engine-port-server": pair(REF, PORT)}


class CpuEngine(port_engine.Engine):
    """The port's ``Engine`` with ``backend=None`` served by
    ``GpuBackend(device="cpu")`` instead of the card."""

    def __init__(self, keys, store, server, node, backend=None, *args,
                 **kw):
        super().__init__(keys, store, server, node,
                         backend or GpuBackend(device="cpu"), *args, **kw)


def cpu_select_backend(prefer=None, params=None):
    """The port's ``select_backend`` with the card's choice served by
    ``GpuBackend(device="cpu")``: what an ``Engine`` that is given no
    backend takes in a case of the port (``ClientApp`` builds it so)."""
    if prefer in (None, "gpu"):
        return GpuBackend(params, device="cpu")
    return port_backend.select_backend(prefer, params)


def _rebind_class(cls, ns):
    """``cls`` re-created with its methods over ``ns`` (a fake transport's
    ``send_data`` must consult the fault plane of the package under
    test)."""
    body = {}
    for k, v in vars(cls).items():
        if k in ("__dict__", "__weakref__"):
            continue
        if isinstance(v, types.FunctionType):
            v = types.FunctionType(v.__code__, ns, v.__name__, v.__defaults__,
                                   v.__closure__)
        body[k] = v
    return type(cls)(cls.__name__, cls.__bases__, body)


def engine_ns(module, pick):
    """``rebind`` plus the classes ``module`` defines; a pick whose engine
    is the port's builds :class:`CpuEngine`."""
    ns = rebind(module, pick)
    for name, obj in vars(module).items():
        if isinstance(obj, type) and obj.__module__ == module.__name__:
            ns[name] = _rebind_class(obj, ns)
    if pick.engine_pkg == PORT and "Engine" in ns:
        ns["Engine"] = CpuEngine
    return ns


def _module_fixtures(module, ns):
    """``{name: (function re-created over ns, autouse)}`` of the fixtures
    ``module`` defines."""
    out = {}
    for name, obj in vars(module).items():
        marker = getattr(obj, "_fixture_function_marker", None)
        if marker is None:
            continue
        fn = obj._get_wrapped_function()
        new = types.FunctionType(fn.__code__, ns, fn.__name__,
                                 fn.__defaults__, fn.__closure__)
        out[marker.name or name] = (new, marker.autouse)
    return out


def _finish(gen):
    for _ in gen:
        pass


def run_ref(module, ns, name, params, request):
    """:func:`run_case` with the fixtures of ``module`` re-created over
    ``ns`` (its autouse ones run first); a generator fixture's teardown
    runs when the case ends.  In a case of a pick whose engine is the
    port's, an engine given no backend takes :func:`cpu_select_backend`."""
    fx = _module_fixtures(module, ns)
    cache = {}

    def value(arg):
        if arg not in cache:
            if arg in fx:
                fn = fx[arg][0]
                v = fn(**{a: value(a)
                          for a in inspect.signature(fn).parameters})
                if inspect.isgenerator(v):
                    gen, v = v, next(v)
                    request.addfinalizer(lambda g=gen: _finish(g))
            else:
                v = request.getfixturevalue(arg)
            cache[arg] = v
        return cache[arg]

    if ns["__pick__"].engine_pkg == PORT:
        request.getfixturevalue("monkeypatch").setattr(
            port_engine, "select_backend", cpu_select_backend)
    for arg, (_fn, autouse) in fx.items():
        if autouse:
            value(arg)
    run_case(module, ns, name, params, request,
             {a: (lambda a=a: value(a)) for a in fx})


def params_of(module, skip=(), only=None, served=tuple(PAIRS),
              alone=("port", "ref")):
    """Each case of ``module`` (those named in ``only``, when given) in
    the pairs that tell something apart: ``served`` (all four by
    default) when it starts a coordination server, else ``alone`` (port
    and ref)."""
    out = []
    for case in cases(module, skip=skip):
        name, params = case.values
        if only is not None and name not in only:
            continue
        mixed = uses_any(module, name, ("CoordinationServer",))
        for p in served if mixed else alone:
            out.append(pytest.param(name, params, p, id=f"{p}-{case.id}"))
    return out


NS = {}


def ns_for(module, p):
    key = (module.__name__, p)
    if key not in NS:
        NS[key] = engine_ns(module, PAIRS[p])
    return NS[key]


# --- the reference's cases, in pairs of packages ------------------------------

# left out, with the reason; the reference's own files still run them
SKIP_TRANSFER = (
    # timing-gated: asserts a wall-clock bound on six concurrent sends,
    # and passes and fails by turns on the same tree in the reference
    "test_stripe_wall_clock_bounded_by_slowest_shard",
)
SKIP_RESTORE_SWARM = (
    # timing-gated (passes and fails by turns in the reference) and
    # needs scenario.ScenarioHarness, not ported yet
    "test_dark_holder_mid_restore_costs_nothing",
    # need scenario.ScenarioHarness, not ported yet
    "test_slow_and_dark_holder_e2e_restores_byte_for_byte",
    "test_legacy_restore_all_only_peers_still_restore",
)
ERASURE_ENGINE_CASES = (
    "test_engine_stripe_geometry_reads_defaults",
    "test_fulfill_spreads_over_min_peers_when_queue_is_deep",
    "test_fulfill_stays_greedy_with_a_shallow_queue",
)
AUDIT_ENGINE_CASES = (
    "test_server_blocks_peer_failing_for_multiple_reporters",
    "test_storage_queue_skips_audit_blocked_candidate",
    "test_audit_e2e_detects_corruption_and_demotes",
    "test_audit_offline_peer_records_miss",
)


@pytest.mark.parametrize("name,params,pair_name", params_of(ref_engine_send))
def test_engine_send_cases(name, params, pair_name, request):
    run_ref(ref_engine_send, ns_for(ref_engine_send, pair_name), name,
            params, request)


@pytest.mark.parametrize("name,params,pair_name",
                         params_of(ref_transfer, skip=SKIP_TRANSFER))
def test_transfer_cases(name, params, pair_name, request):
    run_ref(ref_transfer, ns_for(ref_transfer, pair_name), name, params,
            request)


@pytest.mark.parametrize("name,params,pair_name",
                         params_of(ref_restore_swarm,
                                   skip=SKIP_RESTORE_SWARM))
def test_restore_swarm_cases(name, params, pair_name, request):
    run_ref(ref_restore_swarm, ns_for(ref_restore_swarm, pair_name), name,
            params, request)


@pytest.mark.parametrize("name,params,pair_name",
                         params_of(ref_erasure, only=ERASURE_ENGINE_CASES))
def test_erasure_engine_cases(name, params, pair_name, request):
    run_ref(ref_erasure, ns_for(ref_erasure, pair_name), name, params,
            request)


@pytest.mark.parametrize("name,params,pair_name",
                         params_of(ref_audit, only=AUDIT_ENGINE_CASES))
def test_audit_engine_cases(name, params, pair_name, request):
    run_ref(ref_audit, ns_for(ref_audit, pair_name), name, params, request)


def test_cases_were_found():
    """Every case named above exists, and the namespaces point at the
    package under test."""
    assert [len(cases(m)) for m in (ref_engine_send, ref_transfer)] == \
        [5, 10]
    names = {c.values[0] for c in cases(ref_restore_swarm)}
    assert set(SKIP_RESTORE_SWARM) <= names
    names = {c.values[0] for c in cases(ref_erasure)}
    assert set(ERASURE_ENGINE_CASES) <= names
    names = {c.values[0] for c in cases(ref_audit)}
    assert set(AUDIT_ENGINE_CASES) <= names
    ns = ns_for(ref_transfer, "port")
    assert ns["Engine"] is CpuEngine
    assert ns["TransferScheduler"].__module__ == f"{PORT}.net.transfer"
    assert ns_for(ref_transfer, "ref")["Engine"].__module__ == \
        f"{REF}.engine"
    from backuwup_tpu_torch import app
    assert app.Engine is port_engine.Engine
    assert app.Messenger.__module__ == f"{PORT}.ui.messenger"
    assert app.ServerClient.__module__ == f"{PORT}.net.client"
    assert app.SeriesRecorder.__module__ == f"{PORT}.obs.series"


# --- parity: one deployment, either package's engine, holders and server -----


def _modules(pkg):
    """The modules of ``pkg`` a deployment uses."""
    import importlib

    def mod(sub):
        return importlib.import_module(f"{pkg}.{sub}")

    return types.SimpleNamespace(
        defaults=mod("defaults"), crypto=mod("crypto"), store=mod("store"),
        client=mod("net.client"), p2p=mod("net.p2p"),
        server=mod("net.server"), engine=mod("engine"),
        backend=mod("ops.backend"), gear=mod("ops.gear"),
        metrics=mod("obs.metrics"))


# CDC at 4 KiB chunks and 256 KiB packfiles, so a tree of ~0.7 MB makes
# a few stripes (every packfile costs ~8 BLAKE3 calls of ~0.1-0.3 s each
# on the CPU: its challenge table, its split and the tables of its six
# shards); no packfile boundary moves with the wall clock
PARITY_DEFAULTS = {"PACKFILE_TARGET_SIZE": 256 * 1024,
                   "PACK_EMIT_MAX_LAG_S": float("inf")}
GRANT = 8 << 20


def _backend(pkg, kind):
    P = _modules(pkg)
    params = P.gear.CDCParams.from_desired(4096)
    if kind == "gpu":
        return P.backend.GpuBackend(params, device="cpu")
    return P.backend.CpuBackend(params)


class _Client:
    """One client of package ``pkg``, wired as ``ClientApp`` wires it:
    identity from ``secret``, store, control-plane client, P2P node; as a
    holder it stores what a matched peer sends and serves its restores,
    fetches, reclaims and audits."""

    def __init__(self, pkg, root, name, secret, addr, hold=True):
        P = _modules(pkg)
        self.keys = P.crypto.KeyManager.from_secret(secret)
        self.id = bytes(self.keys.client_id)
        self.store = P.store.Store(root / name / "cfg",
                                   data_base=root / name / "data")
        self.store.set_obfuscation_key(secret[:4])
        self.client = P.client.ServerClient(self.keys, self.store,
                                            addr=addr, tls=False)
        self.node = P.p2p.P2PNode(self.keys, self.store, self.client)
        if hold:
            prover = _backend(pkg, "cpu")
            node = self.node

            async def accept(source, transport):
                w = P.p2p.ReceivedFilesWriter(self.store, source)
                await P.p2p.Receiver(transport, w.sink, part_sink=w.sink_part,
                                     resume_query=w.resume_offer).run()

            async def audit(source, transport):
                await node.serve_audit(source, transport, prover)

            node.on_transport_request = accept
            node.on_restore_request = node.serve_restore
            node.on_restore_fetch_request = node.serve_restore_fetch
            node.on_reclaim_request = node.serve_reclaim
            node.on_audit_request = audit

    async def join(self):
        await self.client.register()
        await self.client.login()
        self.client.start_ws()
        await asyncio.wait_for(self.client.ws_connected.wait(), 10)

    async def close(self):
        await self.client.close()
        self.store.close()


def make_trees(root):
    """The two states of the backed-up tree, written once: a snapshot's
    tree blobs record each path's mtime and ctime, so every deployment
    backs up the same files on disk.  The second state drops a file,
    changes one, adds one and keeps the rest."""
    rng = random.Random(31)
    big = rng.randbytes(300_000)
    notes = rng.randbytes(400_000)
    extra = rng.randbytes(120_000)
    cfg = b"alpha=1\nbeta=2\n"
    for name, files in (
            ("src1", {"big.bin": big, "rep.bin": big,
                      "docs/notes.txt": notes, "small.cfg": cfg}),
            ("src2", {"big.bin": big, "rep.bin": big,
                      "docs/new.bin": extra,
                      "small.cfg": cfg + b"gamma=3\n"})):
        for rel, data in files.items():
            p = root / name / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(data)
    return root / "src1", root / "src2"


def _digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def _stripes(engine, indexes=True):
    """Placement rows with each packfile named by its content (its blob
    hashes): ``(content, shard index, size)``, sorted; every stripe's
    shards on distinct peers.  Which holder takes which index depends on
    the order in which transports open, so once holders are lost (which
    indexes they held varies) ``indexes=False`` counts each stripe's
    shards instead: ``(content, shards, size)``."""
    names = {}
    for h, pid in engine.index.blob_map().items():
        names.setdefault(bytes(pid), []).append(bytes(h))
    names = {pid: hashlib.sha256(b"".join(sorted(hs))).hexdigest()[:16]
             for pid, hs in names.items()}
    rows, peers = [], {}
    for pid, peer, size, idx, _sent_at in engine.store.all_placements():
        rows.append((names.get(pid, "?"), idx, size))
        peers.setdefault(pid, []).append(peer)
    assert all(len(set(p)) == len(p) for p in peers.values())
    if not indexes:
        count = {}
        for name, idx, size in rows:
            key = (name, idx >= 0, size)
            count[key] = count.get(key, 0) + 1
        rows = [(name, striped, n, size)
                for (name, striped, size), n in count.items()]
    return sorted(rows)


async def _deploy(tmp, trees, engine_pkg, holder_pkg, kind,
                  first_backup_only=False):
    """One owner (``engine_pkg``'s ``Engine`` over ``kind``) and seven
    holders on a server of ``holder_pkg``: two backups, two holders dark
    and a repair round, a GC pass, a restore onto a fresh store; the facts
    each step leaves."""
    E, H = _modules(engine_pkg), _modules(holder_pkg)
    server = H.server.CoordinationServer(db_path=str(tmp / "server.db"))
    port = await server.start()
    addr = f"127.0.0.1:{port}"
    holders = [_Client(holder_pkg, tmp, f"h{i}", bytes([0x40 + i]) * 32,
                       addr) for i in range(7)]
    owner = _Client(engine_pkg, tmp, "owner", b"\x11" * 32, addr,
                    hold=False)
    clients = holders + [owner]
    facts = {}
    try:
        for c in clients:
            await c.join()
        # six holders negotiated; the seventh joins before the repair
        for h in holders[:6]:
            owner.store.add_peer_negotiated(h.id, GRANT)
            h.store.add_peer_negotiated(owner.id, GRANT)
            server.db.save_storage_negotiated(owner.id, h.id, GRANT)
        eng = E.engine.Engine(owner.keys, owner.store, owner.client,
                              owner.node, backend=_backend(engine_pkg, kind))
        eng.auto_repair = False  # the repair round is driven below
        await eng.recover()
        src1, src2 = trees
        roots = [await eng.run_backup(src1)]
        stats = [asdict(eng.last_pack_stats)]
        facts["report"] = eng.last_pipeline_report
        if first_backup_only:
            return facts
        roots.append(await eng.run_backup(src2))
        stats.append(asdict(eng.last_pack_stats))
        for s in stats:
            s.pop("chunk_hash_s")  # wall seconds
        facts.update(roots=roots, stats=stats,
                     placed=_stripes(eng),
                     manifest=sorted(eng.store.manifest_blobs().items()))
        # two holders dark; three missed audits demote each (the
        # engine's ledger), then one repair round re-homes what it can on
        # the seventh (one shard of each stripe: the others hold one)
        dark = holders[:2]
        for h in dark:
            await h.client.close()
        t0 = time.time()
        for h in dark:
            for i in range(E.defaults.AUDIT_DEMOTE_MISSES):
                await eng.audit_peer(h.id, now=t0 + i)
            assert eng.store.get_audit_state(h.id).demoted
        spare = holders[6]
        owner.store.add_peer_negotiated(spare.id, GRANT)
        spare.store.add_peer_negotiated(owner.id, GRANT)
        server.db.save_storage_negotiated(owner.id, spare.id, GRANT)
        rep = await eng.repair_round(now=t0 + 10)
        rep["peers"] = len(rep["peers"])
        facts.update(repair=rep, after_repair=_stripes(eng, False))
        # retention keeps the second snapshot only: GC drops and compacts
        # the first's packfiles over the live holders
        gc = await eng.run_gc("keep-last:1")
        gc.pop("elapsed_s")
        facts.update(
            gc=gc, after_gc=_stripes(eng, False),
            snapshots=[(s.hash, s.parent, s.size, s.pruned_at > 0)
                       for s in eng.store.list_snapshots()],
            live=sorted(eng.store.live_blobs().items()))
        # a lost machine: a fresh store under the same identity
        lost = _Client(engine_pkg, tmp, "owner2", b"\x11" * 32, addr,
                       hold=False)
        clients.append(lost)
        await lost.join()
        eng2 = E.engine.Engine(lost.keys, lost.store, lost.client, lost.node,
                               backend=_backend(engine_pkg, kind))
        await eng2.recover()
        dest = await eng2.run_restore(tmp / "restored")
        assert _digest(dest) == _digest(src2)
        facts["restored"] = _digest(dest)
        await eng.aclose()
        await eng2.aclose()
    finally:
        for c in clients[2:]:
            await c.close()
        for c in clients[:2]:
            c.store.close()
        await server.stop()
    return facts


PARITY_PAIRS = {"ref": (REF, REF), "port": (PORT, PORT),
                "port-engine-ref-holders": (PORT, REF),
                "ref-engine-port-holders": (REF, PORT)}
ORACLE = {}


def _run_deploy(tmp, engine_pkg, holder_pkg, kind, monkeypatch, **kw):
    for pkg in (PORT, REF):
        for name, value in PARITY_DEFAULTS.items():
            monkeypatch.setattr(_modules(pkg).defaults, name, value)
    # the send loop starts once the pack is sealed, so one admission tick
    # dials each holder once: two ticks dialing one holder at once race
    # on its pending connection request (``ConnectionRequests``, both
    # packages), and the loser's packfile goes out whole instead of as a
    # stripe, which would make the placements differ from run to run
    monkeypatch.setenv("BKW_BACKUP_PHASED", "1")
    if "trees" not in ORACLE:
        ORACLE["trees"] = make_trees(tmp.parent / "engine_parity_trees")
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(
            _deploy(tmp, ORACLE["trees"], engine_pkg, holder_pkg, kind,
                    **kw), 120))
    finally:
        loop.close()


def _oracle(tmp_path_factory, monkeypatch):
    """The reference engine over ``CpuBackend`` with reference holders,
    run once per process (by the ``ref`` case, or when a case runs
    without it)."""
    if "facts" not in ORACLE:
        ORACLE["facts"] = _run_deploy(tmp_path_factory.mktemp("oracle"),
                                      REF, REF, "cpu", monkeypatch)
    return ORACLE["facts"]


@pytest.mark.parametrize("pair_name", PARITY_PAIRS)
def test_engine_parity(pair_name, tmp_path, tmp_path_factory, monkeypatch):
    """Tolerance 0 against the reference engine over ``CpuBackend``:
    snapshot roots; the snapshot, manifest and placement rows (each
    stripe by its content, its shard indexes and sizes); the pack
    statistics of both backups; the repair report and the rows after two
    holders went dark; the GC report after it; the bytes a
    fresh store under the same identity restores.  The port's engine runs
    over ``GpuBackend(device="cpu")`` (its tiered front on the CPU)."""
    engine_pkg, holder_pkg = PARITY_PAIRS[pair_name]
    kind = "gpu" if engine_pkg == PORT else "cpu"
    got = _run_deploy(tmp_path, engine_pkg, holder_pkg, kind, monkeypatch)
    if pair_name == "ref":
        ORACLE.setdefault("facts", got)
    want = _oracle(tmp_path_factory, monkeypatch)
    for key in ("roots", "stats", "placed", "manifest", "repair",
                "after_repair", "gc", "after_gc", "snapshots", "live",
                "restored"):
        assert got[key] == want[key], key
    assert got["repair"]["shards_rebuilt"] > 0
    assert got["gc"]["snapshots_pruned"] == 1


def test_pipeline_report_matches_reference(tmp_path, tmp_path_factory,
                                           monkeypatch):
    """``obs/profile.report`` over the first backup: the port's engine on
    the port's ``CpuBackend`` gives the reference's keys and counts
    (dispatches, bytes, padded bytes and pad efficiency per stage; the
    stage seconds are wall times, so only their span names are held)."""
    got = _run_deploy(tmp_path, PORT, PORT, "cpu", monkeypatch,
                      first_backup_only=True)["report"]
    want = _oracle(tmp_path_factory, monkeypatch)["report"]
    assert sorted(got) == sorted(want)
    for key in ("dispatches", "bytes", "padded_bytes", "pad_efficiency"):
        assert got[key] == want[key], key
    assert set(got["stage_seconds"]) == set(want["stage_seconds"])
    assert got["dispatches"]["scan"] > 0 and got["dispatches"]["index"] > 0


def test_device_timer_and_trace_hook_on_the_cpu(tmp_path, monkeypatch):
    """``obs/profile.dev_time`` over CPU tensors brackets the calls with
    the host clock (CUDA events are for CUDA tensors: the card tests);
    ``dev_time_stage`` files the time under ``bkw_profile_stage_seconds``
    as the reference's does; ``device_profiler`` does nothing without
    ``BKW_TRACE_DIR`` and writes a Chrome trace under it when set."""
    import json

    import torch

    from backuwup_tpu.obs import profile as ref_profile
    from backuwup_tpu_torch.obs import metrics as obs_metrics
    from backuwup_tpu_torch.obs import profile
    from backuwup_tpu_torch.utils import tracing

    calls = []
    x = torch.ones(1024)
    dt = profile.dev_time(lambda t: calls.append(t.sum()), x, n=5)
    assert dt > 0 and len(calls) == 6  # one warm-up, five timed
    profile.dev_time_stage("digest", lambda t: t * 2, x, n=3)
    fam = obs_metrics.registry().get("bkw_profile_stage_seconds")
    assert fam.sum_value(stage="digest") > 0
    assert set(profile.STAGES) == set(ref_profile.STAGES)
    assert profile.REPORT_SPANS == ref_profile.REPORT_SPANS

    monkeypatch.delenv("BKW_TRACE_DIR", raising=False)
    with tracing.device_profiler("idle"):
        pass
    assert not (tmp_path / "idle").exists()
    monkeypatch.setenv("BKW_TRACE_DIR", str(tmp_path))
    with tracing.device_profiler("backup_pack"):
        (x * 3).sum()
    trace = json.loads((tmp_path / "backup_pack" / "trace.json").read_text())
    assert trace["traceEvents"]
