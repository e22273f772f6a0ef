"""The port's coordination plane vs the JAX package's.

The reference's own cases run through both packages: the non-slow cases
of ``tests/test_matchmaking.py`` and ``tests/test_serverstore_contract.py``
and those of ``tests/test_replication.py`` that need no ``scenario``.  Each
case is the reference test function itself, re-created over a namespace
in which every name its module imports from ``backuwup_tpu`` resolves in
the package under test (:func:`rebind`), so the port is held to the same
assertions, line for line.  On top of those, at tolerance 0: each
package's ``SqliteServerStore`` file and ``OpLog`` opened and read by the
other, ``ring.py`` placing the same keys on the same nodes, and the same
match order under one scripted clock.

The helpers here (:func:`rebind`, :func:`cases`, :func:`run_case`,
:class:`BoundedLoop`) also drive ``tests/test_torch_net_p2p.py``.
"""

import ast
import asyncio
import contextlib
import importlib
import inspect
import sqlite3
import sys
import types

import pytest

import test_matchmaking as ref_matchmaking
import test_replication as ref_replication
import test_serverstore_contract as ref_contract
from backuwup_tpu.net import matchmaking as ref_mm
from backuwup_tpu.net import ring as ref_ring
from backuwup_tpu.net import serverstore as ref_ss
from backuwup_tpu.obs import metrics as ref_metrics
from backuwup_tpu.utils import faults as ref_faults
from backuwup_tpu_torch.net import matchmaking as mm
from backuwup_tpu_torch.net import ring
from backuwup_tpu_torch.net import serverstore as ss
from backuwup_tpu_torch.obs import metrics as obs_metrics
from backuwup_tpu_torch.utils import faults

REF, PORT = "backuwup_tpu", "backuwup_tpu_torch"
# every network case runs under its own time limit (BoundedLoop)
NET_TIMEOUT_S = 60.0
MIB = 1 << 20


# --- running the reference's cases against a package -------------------------


class BoundedLoop(asyncio.SelectorEventLoop):
    """An event loop whose ``run_until_complete`` runs a coroutine under
    ``asyncio.wait_for`` with :data:`NET_TIMEOUT_S`: a wedged network
    case fails with a timeout instead of hanging its worker."""

    def run_until_complete(self, future):
        if asyncio.iscoroutine(future):
            future = asyncio.wait_for(future, NET_TIMEOUT_S)
        return super().run_until_complete(future)


def _ref_imports(module):
    """``(bound name, module path, attribute, at top level)`` of every
    ``from backuwup_tpu... import`` in ``module``'s source."""
    tree = ast.parse(inspect.getsource(module))
    top = {id(node) for node in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and not node.level and (
                node.module == REF or node.module.startswith(REF + ".")):
            for alias in node.names:
                yield (alias.asname or alias.name, node.module, alias.name,
                       id(node) in top)


def _sub(module_path: str) -> str:
    """The path under the package: ``backuwup_tpu.net.p2p`` -> ``net.p2p``."""
    return module_path[len(REF):].lstrip(".")


def _resolve(pkg: str, module_path: str, attr: str):
    sub = _sub(module_path)
    mod = importlib.import_module(".".join(p for p in (pkg, sub) if p))
    try:
        return getattr(mod, attr)
    except AttributeError:  # a submodule not yet imported as an attribute
        return importlib.import_module(f"{mod.__name__}.{attr}")


def _over(fn, ns):
    """``fn`` re-created with ``ns`` as its globals."""
    new = types.FunctionType(fn.__code__, ns, fn.__name__, fn.__defaults__,
                             fn.__closure__)
    new.__kwdefaults__ = fn.__kwdefaults__
    return new


def rebind(module, pick):
    """A namespace in which ``module``'s functions run against the
    packages ``pick`` chooses.

    ``pick(path)`` names the package (``REF`` or ``PORT``) for a module
    path under it (``"net.server"``, ``"store"``; for ``from backuwup_tpu
    import defaults`` the path is ``"defaults"``).  Every name ``module``
    imports at top level from the reference is re-resolved in the picked
    package, and every function ``module`` defines is re-created over the
    new namespace, so helpers and nested functions see it too.  Imports
    inside functions are served by :func:`run_case`."""
    ns = dict(vars(module))
    for name, path, attr, top in _ref_imports(module):
        if top:
            ns[name] = _resolve(pick(_sub(path) or attr), path, attr)
    for name, obj in vars(module).items():
        if isinstance(obj, types.FunctionType) and \
                obj.__module__ == module.__name__:
            wrapped = getattr(obj, "__wrapped__", None)
            if obj.__code__.co_filename == contextlib.__file__ and \
                    wrapped is not None:
                # a (async) context manager: its generator over ``ns``
                inner = _over(wrapped, ns)
                ns[name] = (contextlib.asynccontextmanager
                            if inspect.isasyncgenfunction(inner)
                            else contextlib.contextmanager)(inner)
            else:
                ns[name] = _over(obj, ns)
    ns["__pick__"] = pick
    return ns


def cases(module, skip=()):
    """One ``pytest.param(name, params)`` per non-slow test function of
    ``module`` and per combination of its ``parametrize`` marks."""
    out = []
    for name, fn in vars(module).items():
        if not name.startswith("test_") or name in skip or \
                not isinstance(fn, types.FunctionType):
            continue
        marks = getattr(fn, "pytestmark", [])
        if any(m.name == "slow" for m in marks):
            continue
        combos = [{}]
        for m in marks:
            if m.name != "parametrize":
                continue
            names = m.args[0]
            names = ([a.strip() for a in names.split(",")]
                     if isinstance(names, str) else list(names))
            combos = [dict(c, **dict(zip(names, v if len(names) > 1
                                         else (v,))))
                      for c in combos for v in m.args[1]]
        for c in combos:
            out.append(pytest.param(
                name, c, id="-".join([name] + [str(v) for v in c.values()])))
    return out


def uses_any(module, name: str, symbols) -> bool:
    """Whether test ``name`` of ``module`` names any of ``symbols``, in
    its body or in a function nested in it."""
    code = getattr(module, name).__code__
    stack, seen = [code], set()
    while stack:
        c = stack.pop()
        seen |= set(c.co_names)
        stack += [k for k in c.co_consts if isinstance(k, types.CodeType)]
    return bool(seen & set(symbols))


def run_case(module, ns, name, params, request, fixtures=None):
    """Call test ``name`` of the namespace ``ns`` (from :func:`rebind`)
    with ``params`` and its other arguments from ``fixtures`` (factories
    for fixtures that depend on the package) or from pytest.  The
    reference modules a case imports inside its body are served from the
    picked package for the duration of the case (a module imported from
    the package itself, ``from backuwup_tpu import defaults``, as the
    package's attribute)."""
    mp = request.getfixturevalue("monkeypatch")
    pick = ns["__pick__"]
    for _name, path, attr, top in _ref_imports(module):
        sub = _sub(path)
        pkg = pick(sub or attr)
        if top or pkg == REF:
            continue
        if sub:
            mp.setitem(sys.modules, path,
                       importlib.import_module(f"{pkg}.{sub}"))
        else:  # ``from backuwup_tpu import defaults`` in a body
            mp.setattr(importlib.import_module(REF), attr,
                       importlib.import_module(f"{pkg}.{attr}"))
    fn = ns[name]
    kwargs = dict(params)
    for arg in inspect.signature(fn).parameters:
        if arg not in kwargs:
            kwargs[arg] = (fixtures[arg]() if fixtures and arg in fixtures
                           else request.getfixturevalue(arg))
    fn(**kwargs)


# what the reference's test modules import that the port does not have
# (only cases left out here use it)
NOT_PORTED = ("scenario",)


def everything(pkg):
    return lambda path: REF if path.split(".")[0] in NOT_PORTED else pkg


NS = {pkg: {mod: rebind(mod, everything(pkg))
            for mod in (ref_matchmaking, ref_contract, ref_replication)}
      for pkg in (PORT, REF)}


@pytest.fixture(autouse=True)
def _isolate():
    """Both packages' registries and fault planes fresh around each case
    (``test_replication.py``'s isolation, for either package)."""
    for reg in (obs_metrics, ref_metrics):
        reg.registry().reset()
    yield
    for reg in (obs_metrics, ref_metrics):
        reg.registry().reset()
    faults.uninstall()
    ref_faults.uninstall()


@pytest.fixture
def loop():
    lp = BoundedLoop()
    yield lp
    lp.close()


@pytest.fixture(params=[PORT, REF], ids=["port", "ref"])
def pkg(request):
    return request.param


# --- the reference's cases, through both packages ------------------------------


@pytest.mark.parametrize("name,params", cases(ref_matchmaking))
def test_matchmaking_cases(name, params, pkg, request):
    run_case(ref_matchmaking, NS[pkg][ref_matchmaking], name, params,
             request)


@pytest.mark.parametrize("kind", ["sqlite", "partitioned", "replicated"])
@pytest.mark.parametrize("name,params", cases(ref_contract))
def test_serverstore_contract_cases(name, params, kind, pkg, request,
                                    tmp_path):
    ns = NS[pkg][ref_contract]
    store = ns["_mk"](kind, tmp_path)
    try:
        run_case(ref_contract, ns, name, params, request,
                 {"kind": lambda: kind, "store": lambda: store})
    finally:
        store.close()


@pytest.mark.parametrize("name,params", cases(
    ref_replication, skip=("test_replication_swarm_permakill",)))
def test_replication_cases(name, params, pkg, request):
    ns = NS[pkg][ref_replication]
    run_case(ref_replication, ns, name, params, request, {
        "plane": lambda: ns["faults"].install(ns["faults"].FaultPlane(
            seed=7))})


def test_cases_were_found():
    """The counts the issue names: 12 matchmaking cases (11 functions,
    one parametrized twice), 11 contract cases, 15 replication cases."""
    assert len(cases(ref_matchmaking)) == 12
    assert len(cases(ref_contract)) == 11
    assert len(cases(ref_replication,
                     skip=("test_replication_swarm_permakill",))) == 15
    # the namespaces really point at the port
    ns = NS[PORT][ref_matchmaking]
    assert ns["ShardedMatchmaker"] is mm.ShardedMatchmaker
    assert ns["defaults"].__name__ == f"{PORT}.defaults"
    assert NS[REF][ref_matchmaking]["ShardedMatchmaker"] is \
        ref_mm.ShardedMatchmaker


# --- each package reads the other's files --------------------------------------


def pk(i: int) -> bytes:
    return i.to_bytes(8, "big") + bytes(24)


def _fill(store):
    """The writes a server makes, through a ``SqliteServerStore``."""
    for i in range(6):
        store.register_client(pk(i))
        store.client_update_logged_in(pk(i))
    store.save_storage_negotiated(pk(0), pk(1), 3 * MIB)
    store.save_storage_negotiated(pk(1), pk(0), 3 * MIB)
    store.save_storage_negotiated(pk(2), pk(0), MIB)
    store.save_storage_negotiated(pk(0), pk(3), 5 * MIB)
    store.delete_storage_negotiated(pk(0), pk(3), 5 * MIB)
    store.save_snapshot(pk(0), b"\x0a" * 32)
    store.save_snapshot(pk(0), b"\x0b" * 32)
    store.save_audit_report(pk(4), pk(5), False, "digest mismatch")
    store.save_audit_report(pk(3), pk(5), False, "missed proof")
    store.save_audit_report(pk(2), pk(5), True, "")
    store.save_repair_report(pk(0), pk(5), 3, 1234, 1234)
    store.reclaim_negotiation(pk(0), pk(1))
    store.flush()


def _read(store):
    return {
        "schema": store.schema_version(),
        "exists": [store.client_exists(pk(i)) for i in range(8)],
        "peers": [sorted(store.get_client_negotiated_peers(pk(i)))
                  for i in range(6)],
        "storing_on": sorted(store.get_clients_storing_on(pk(0))),
        "snapshots": [store.get_latest_client_snapshot(pk(i))
                      for i in range(2)],
        "failing": store.audit_failing_reporters(pk(5), 3600.0),
    }


def _schema(path):
    con = sqlite3.connect(str(path))
    try:
        return sorted(r for r in con.execute(
            "SELECT type, name, sql FROM sqlite_master"))
    finally:
        con.close()


@pytest.mark.parametrize("writer,reader", [(ss, ref_ss), (ref_ss, ss)],
                         ids=["port-writes", "ref-writes"])
def test_sqlite_server_store_cross_opened(writer, reader, tmp_path):
    """A database one package's server wrote, opened by the other's: the
    same schema, and every read the server makes returns the same."""
    a = writer.SqliteServerStore(str(tmp_path / "a.db"))
    _fill(a)
    want = _read(a)
    a.close()
    b = reader.SqliteServerStore(str(tmp_path / "a.db"))
    try:
        assert _read(b) == want
        assert want["failing"] == 2 and want["peers"][0] == []
        # the reader's own fresh file has the writer's schema
        c = reader.SqliteServerStore(str(tmp_path / "c.db"))
        c.close()
        assert _schema(tmp_path / "c.db") == _schema(tmp_path / "a.db")
        b.register_client(pk(9))  # and writes on where the other stopped
        assert b.client_exists(pk(9))
    finally:
        b.close()


def test_oplog_files_byte_identical_and_cross_read(tmp_path):
    """The replication log: the same records append the same bytes, and
    each package loads the other's log (epoch sidecar included)."""
    recs = [{"lsn": i, "epoch": 0, "op": "save_storage_negotiated",
             "args": ss.encode_value([pk(i), pk(i + 1), MIB]), "ts": 1.5}
            for i in (1, 2, 3)]
    for name, mod in (("port", ss), ("ref", ref_ss)):
        (tmp_path / name).mkdir()
        log = mod.OpLog(tmp_path / name / "p.log")
        log.append(recs)
        log.set_epoch(2)
    assert (tmp_path / "port" / "p.log").read_bytes() == \
        (tmp_path / "ref" / "p.log").read_bytes()
    for reader, other in ((ss, "ref"), (ref_ss, "port")):
        got = reader.OpLog(tmp_path / other / "p.log")
        assert got.epoch == 2 and got.last_lsn == 3
        assert [reader.decode_value(r["args"]) for r in got.records] == \
            [[pk(i), pk(i + 1), MIB] for i in (1, 2, 3)]
    assert ss.encode_value([pk(1), None, 2.5, "x"]) == \
        ref_ss.encode_value([pk(1), None, 2.5, "x"])


# --- the ring places the same keys on the same nodes -----------------------------


def test_ring_places_keys_alike(nprng):
    nodes = [f"node-{i}" for i in range(5)]
    keys = [bytes(k) for k in nprng.integers(0, 256, (2000, 32),
                                             dtype="uint8")]
    a, b = ring.HashRing(nodes), ref_ring.HashRing(nodes)
    assert [a.owner(k) for k in keys] == [b.owner(k) for k in keys]
    assert a.nodes() == b.nodes()
    for n in nodes:
        assert a.steal_order(n) == b.steal_order(n)
    for p in range(16):
        assert ring.partition_key(p) == ref_ring.partition_key(p)
        assert ring.successors(a, p, 2) == ref_ring.successors(b, p, 2)
    assert [ring.partition_of(k, 4) for k in keys] == \
        [ref_ring.partition_of(k, 4) for k in keys]
    # bounded movement holds alike when a node joins and one leaves
    a.add("node-5")
    b.add("node-5")
    a.remove("node-1")
    b.remove("node-1")
    assert [a.owner(k) for k in keys] == [b.owner(k) for k in keys]


# --- one scripted clock, the same match order ---------------------------------


class _Clock:
    """A clock the script moves by hand."""

    def __init__(self):
        self.t = 1000.0

    def now(self):
        return self.t

    def monotonic(self):
        return self.t

    async def sleep(self, delay):
        self.t += delay


class _Conns:
    """Every push delivered, in order; clients in ``offline`` are not."""

    def __init__(self):
        self.log = []
        self.offline = set()

    def is_online(self, client_id):
        return bytes(client_id) not in self.offline

    async def notify(self, client_id, msg):
        self.log.append((bytes(client_id), bytes(msg.destination_id),
                         int(msg.storage_available)))
        return True


def _match_script(mod, store_mod, tmp_path, seed):
    """A seeded run of requests (sizes, spreads, backlogs, expiries,
    offline candidates) through one package's ``ShardedMatchmaker``;
    returns the pushes in order, the negotiated edges and what stays
    queued."""
    import random

    rnd = random.Random(seed)
    tmp_path.mkdir()
    store = store_mod.SqliteServerStore(str(tmp_path / "m.db"))
    clock, conns = _Clock(), _Conns()
    m = mod.ShardedMatchmaker(store, conns, expiry_s=30.0, shards=4,
                              clock=clock)

    async def run():
        for step in range(160):
            who = pk(rnd.randrange(24))
            if rnd.random() < 0.1:
                conns.offline.symmetric_difference_update({who})
                continue
            if rnd.random() < 0.15:
                # a backlog of distinct requesters (as concurrent requests
                # leave it), so spreads over min_peers cap the matches
                for j in rnd.sample(range(24), rnd.randrange(2, 9)):
                    m._enqueue(pk(j), rnd.randrange(1, 9) * MIB,
                               clock.t + rnd.choice((5.0, 30.0)))
            clock.t += rnd.choice((0.5, 1.0, 7.0, 31.0))
            await m.fulfill(who, rnd.randrange(1, 9) * MIB,
                            min_peers=rnd.choice((1, 1, 2, 6)))

    try:
        asyncio.run(asyncio.wait_for(run(), NET_TIMEOUT_S))
        edges = {i: sorted(store.get_client_negotiated_peers(pk(i)))
                 for i in range(24)}
        queued = sorted((e[0], e[1]) for s in m.shards
                        for e in s.entries.values())
        return conns.log, edges, queued, m.pending(), m.reap_ops()
    finally:
        store.close()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_match_order_identical_under_one_clock(seed, tmp_path):
    port = _match_script(mm, ss, tmp_path / "port", seed)
    ref = _match_script(ref_mm, ref_ss, tmp_path / "ref", seed)
    assert len(port[0]) > 20  # the script really matched
    assert port == ref
