"""The port's client app, dashboard and SLO plane vs the JAX package's.

The reference's own cases run over the port: those of ``tests/test_ui.py``,
``tests/test_integration.py`` (but for its mesh case, which waits for the
port's multi-device mesh), ``tests/test_tls.py``, ``tests/test_dataflow.py``,
``tests/test_obs.py``, ``tests/test_timeline.py``, ``tests/test_slo.py``
(``sim.clock`` stays the reference's until ``sim/`` is ported) and
``tests/test_failure.py``.  Each case is the reference test function
re-created over a namespace whose ``backuwup_tpu`` imports resolve in the
port (``rebind`` and ``run_ref`` of ``tests/test_torch_engine.py``, which
also re-create the module's fixtures).  A case that starts a coordination
server runs port against port, the port's app against the reference's
server, and the reference's app against the port's server; the others run
over the port.  The reference's files run it against itself.  In a case of
the port a ``ClientApp`` given no backend takes ``GpuBackend(device="cpu")``
(:func:`test_torch_engine.cpu_select_backend`); string constants that name
the reference's modules (a child process's imports, a logger's name) name
the port's (:func:`retarget`).

On top of those, at tolerance 0 (:func:`test_client_app_parity`): the
port's ``ClientApp`` over ``GpuBackend(device="cpu")`` and the reference's
over ``CpuBackend``, with one root secret, one obfuscation key and one
seeded tree, each against a reference server and holder, driven over their
dashboards: equal snapshot roots and restored bytes, equal store rows,
the same messenger events (kinds and payloads, time fields removed), equal
dashboard replies to ``get_config`` and ``config`` and equal ``/healthz``
keys; and (:func:`test_explain_and_timeline_parity`) equal ``explain``
reports over one fixed series and byte-identical ``export_timeline``
documents of one fixed journal.
"""

import asyncio
import hashlib
import json
import math
import random
import re
import types
from dataclasses import asdict

import pytest

import test_dataflow as ref_dataflow
import test_failure as ref_failure
import test_integration as ref_integration
import test_obs as ref_obs
import test_slo as ref_slo
import test_timeline as ref_timeline
import test_tls as ref_tls
import test_ui as ref_ui
from test_torch_engine import (PAIRS, _Client, _digest, _modules, ns_for,
                               params_of, run_ref)
from test_torch_net_server import PORT, REF, cases
from test_torch_net_server import _isolate  # noqa: F401  (autouse)

# a case that starts a server: port against port, and each package's app
# against the other's server; any other case: the port
SERVED = ("port", "port-engine-ref-server", "ref-engine-port-server")
ALONE = ("port",)

# left out, with the reason; the reference's own files still run them
SKIP_INTEGRATION = (
    # the JAX mesh backend (``TpuBackend`` over ``jax.sharding.Mesh``):
    # the port's multi-device mesh is not ported yet
    "test_two_client_cycle_device_backend_and_mesh_dedup",
)
SKIP_SLO = (
    # drives the reference's ``scenario.ScenarioHarness`` (its apps, its
    # registry): ``scenario/`` is not ported yet
    "test_diagnosis_scenario_gate",
)
SKIP_FAILURE = (
    # timing-gated: under the suite's six workers it fails by turns in
    # the reference too ("B should hold exactly its pre-death sends",
    # ``assert 1 == 2``: the peer's death lands before its second ack)
    "test_chaos_peer_death_repair_and_dark_restore",
)
SKIP_DATAFLOW = (
    # timing-gated: whether the packer outruns the slowed wire enough to
    # pause it depends on the host's load; under the suite's six workers
    # it fails by turns in the reference too (``assert any(paused_seen)``)
    "test_backpressure_bounds_buffer_and_drains",
)
# run port against port only: the case reads the server's span from the
# journal its own package installed, and in one process each package
# keeps its own journal
PORT_ONLY = ("test_client_server_trace_propagation",)

_REF_NAME = re.compile(r"\bbackuwup_tpu\b(?!_torch)")


def _retarget_code(code, pkg):
    consts = []
    for c in code.co_consts:
        if isinstance(c, str):
            c = _REF_NAME.sub(pkg, c)
        elif isinstance(c, types.CodeType):
            c = _retarget_code(c, pkg)
        consts.append(c)
    return code.replace(co_consts=tuple(consts))


def retarget(ns, pkg):
    """``ns`` with the string constants of its test functions (and of the
    functions nested in them) naming ``pkg``'s modules where they named
    the reference's: a child process's program, a logger's name."""
    if pkg == REF:
        return ns
    ns = dict(ns)
    for name, fn in list(ns.items()):
        if name.startswith("test_") and isinstance(fn, types.FunctionType):
            new = types.FunctionType(_retarget_code(fn.__code__, pkg), ns,
                                     name, fn.__defaults__, fn.__closure__)
            new.__kwdefaults__ = fn.__kwdefaults__
            ns[name] = new
    return ns


NS = {}


def app_ns(module, p):
    key = (module.__name__, p)
    if key not in NS:
        NS[key] = retarget(ns_for(module, p), PAIRS[p].engine_pkg)
    return NS[key]


def _params(module, skip=()):
    return [p for p in params_of(module, skip=skip, served=SERVED,
                                 alone=ALONE)
            if p.values[0] not in PORT_ONLY or p.values[2] == "port"]


def _run(module, name, params, pair_name, request):
    run_ref(module, app_ns(module, pair_name), name, params, request)


# --- the reference's cases, over the port ---------------------------------------


@pytest.mark.parametrize("name,params,pair_name", _params(ref_ui))
def test_ui_cases(name, params, pair_name, request):
    _run(ref_ui, name, params, pair_name, request)


@pytest.mark.parametrize("name,params,pair_name",
                         _params(ref_integration, skip=SKIP_INTEGRATION))
def test_integration_cases(name, params, pair_name, request):
    _run(ref_integration, name, params, pair_name, request)


@pytest.mark.parametrize("name,params,pair_name", _params(ref_tls))
def test_tls_cases(name, params, pair_name, request):
    _run(ref_tls, name, params, pair_name, request)


@pytest.mark.parametrize("name,params,pair_name",
                         _params(ref_dataflow, skip=SKIP_DATAFLOW))
def test_dataflow_cases(name, params, pair_name, request):
    _run(ref_dataflow, name, params, pair_name, request)


@pytest.mark.parametrize("name,params,pair_name", _params(ref_obs))
def test_obs_cases(name, params, pair_name, request):
    _run(ref_obs, name, params, pair_name, request)


@pytest.mark.parametrize("name,params,pair_name", _params(ref_timeline))
def test_timeline_cases(name, params, pair_name, request):
    _run(ref_timeline, name, params, pair_name, request)


@pytest.mark.parametrize("name,params,pair_name",
                         _params(ref_slo, skip=SKIP_SLO))
def test_slo_cases(name, params, pair_name, request):
    _run(ref_slo, name, params, pair_name, request)


@pytest.mark.parametrize("name,params,pair_name",
                         _params(ref_failure, skip=SKIP_FAILURE))
def test_failure_cases(name, params, pair_name, request):
    _run(ref_failure, name, params, pair_name, request)


def test_cases_were_found():
    """The counts the reference's files hold, and namespaces that point at
    the port."""
    counts = {m.__name__: len(cases(m)) for m in (
        ref_ui, ref_integration, ref_tls, ref_dataflow, ref_obs,
        ref_timeline, ref_slo, ref_failure)}
    assert counts == {"test_ui": 7, "test_integration": 5, "test_tls": 4,
                      "test_dataflow": 4, "test_obs": 20,
                      "test_timeline": 5, "test_slo": 13,
                      "test_failure": 24}
    for module, skip in ((ref_integration, SKIP_INTEGRATION),
                         (ref_slo, SKIP_SLO), (ref_failure, SKIP_FAILURE),
                         (ref_dataflow, SKIP_DATAFLOW),
                         (ref_obs, PORT_ONLY)):
        assert set(skip) <= {c.values[0] for c in cases(module)}
    from backuwup_tpu_torch import app as port_app
    from backuwup_tpu_torch.ui import server as port_ui_server
    ns = app_ns(ref_ui, "port")
    assert ns["ClientApp"] is port_app.ClientApp
    assert ns["UIServer"] is port_ui_server.UIServer
    assert ns["ui_cli"].__name__ == f"{PORT}.ui.cli"
    ns = app_ns(ref_slo, "port")
    assert ns["SeriesRecorder"].__module__ == f"{PORT}.obs.series"
    assert ns["obs_diagnose"].__name__ == f"{PORT}.obs.diagnose"
    assert ns["SimClock"].__module__ == f"{REF}.sim.clock"
    ns = app_ns(ref_integration, "port-engine-ref-server")
    assert ns["ClientApp"] is port_app.ClientApp
    assert ns["CoordinationServer"].__module__ == f"{REF}.net.server"
    prog = app_ns(ref_obs, "port")[
        "test_obs_runs_without_accelerator"].__code__.co_consts
    assert any(f"from {PORT}.obs import" in c for c in prog
               if isinstance(c, str))


# --- parity: one user's app of either package, tolerance 0 ---------------------

SECRET = bytes(range(7, 39))
OBF = b"\x5a\x17\xc3\x02"
HOLDER_SECRET = b"\x42" * 32
GRANT = 8 << 20
# a time or a duration in a log line ("in 0.012s", "1.5 s") and a
# listener's ephemeral port
_SECONDS = re.compile(r"\d+\.\d+ ?s\b")
_PORT = re.compile(r"127\.0\.0\.1:\d+")
# time fields of the messenger's payloads (``Messenger.transfer``)
TIME_FIELDS = ("wait_ms", "send_ms", "stages", "overlap")


def _app_modules(pkg):
    import importlib

    def mod(sub):
        return importlib.import_module(f"{pkg}.{sub}")

    return types.SimpleNamespace(
        app=mod("app"), ui=mod("ui.server"), messenger=mod("ui.messenger"),
        crypto=mod("crypto"))


def _tree(root):
    rng = random.Random(23)
    files = {"a.bin": rng.randbytes(200_000), "b.bin": rng.randbytes(90_000),
             "sub/c.txt": b"seeded tree\n" * 300,
             "sub/deep/d.bin": rng.randbytes(40_000)}
    for rel, data in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
    return root


def _events(messenger, tmp, names):
    """The messenger's events, time fields removed: each ``(kind,
    payload)`` with the payload's times dropped, the seconds, ports and
    the run's directory in a log line's text masked, and each packfile
    id (random) named by its content (``names``).  The progress and peer
    frames the dashboard's ticker pushes on its clock are left out; the
    last progress snapshot ends the list."""
    ids = {pid.hex()[:8]: name for pid, name in names.items()}
    ids_re = re.compile("|".join(ids) or "$^")

    def mask(v):
        if not isinstance(v, str):
            return v
        v = _PORT.sub("127.0.0.1:<port>", v.replace(str(tmp), "<tmp>"))
        return ids_re.sub(lambda m: ids[m.group(0)], _SECONDS.sub("<t>", v))

    out = []
    for ev in messenger.history:
        if ev.kind in ("progress", "peers"):
            continue
        out.append((ev.kind, {k: mask(v) for k, v in ev.payload.items()
                              if k not in TIME_FIELDS}))
    out.append(("progress", {k: mask(v) for k, v in
                             asdict(messenger.progress_state).items()}))
    return out


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in sorted(obj.items())}
    return None


def _store_rows(store, names):
    """The owner's store, its time columns left out and each packfile named
    by its content (``names``: packfile id -> name)."""
    db = store._db
    q = lambda sql: [tuple(bytes(v) if isinstance(v, (bytes, memoryview))
                           else v for v in r) for r in db.execute(sql)]
    rows = {
        # the server's session token is random, the backup path the run's
        "config": sorted(r for r in q("SELECT key, value FROM config")
                         if r[0] not in ("auth_token", "backup_path")),
        "peers": sorted(q("SELECT pubkey, bytes_transmitted, "
                          "bytes_received, bytes_negotiated FROM peers")),
        "log": [r[0] for r in q("SELECT event FROM log ORDER BY id")],
        "placements": sorted((names.get(r[0], "?"),) + r[1:] for r in q(
            "SELECT packfile_id, peer, size, shard_index FROM placements")),
        "audit": sorted(q("SELECT * FROM audit_ledger")),
        "snapshots": sorted(q("SELECT hash, parent, size, pruned_at "
                              "FROM snapshots")),
        "snapshot_blobs": sorted(q("SELECT * FROM snapshot_blobs")),
    }
    return rows


async def _drive(ws, command, until, **fields):
    """Send ``command`` over the dashboard socket and gather the frames up
    to the first of kind ``until``; ``error`` frames fail the case."""
    await ws.send_str(json.dumps(dict(fields, command=command)))
    got = []
    while True:
        ev = json.loads(await asyncio.wait_for(ws.receive_str(), 60))
        assert ev["kind"] not in ("error", "panic"), ev
        if ev["kind"] not in ("progress", "peers"):
            got.append((ev["kind"], ev["payload"]))
        if ev["kind"] == until:
            return got


async def _user(tmp, pkg, tree):
    """One user's app of ``pkg`` against a reference server and one
    reference holder: a backup over the dashboard, then a lost machine
    recovered from the phrase restores over its own dashboard."""
    import aiohttp

    A, R = _app_modules(pkg), _modules(REF)
    params = _modules(pkg).gear.CDCParams.from_desired(4096)

    def backend():
        B = _modules(pkg).backend
        return (B.GpuBackend(params, device="cpu") if pkg == PORT
                else B.CpuBackend(params))

    tmp.mkdir(parents=True)
    server = R.server.CoordinationServer(db_path=str(tmp / "server.db"))
    port = await server.start()
    addr = f"127.0.0.1:{port}"
    holder = _Client(REF, tmp, "holder", HOLDER_SECRET, addr)
    await holder.join()
    facts, apps, uis = {}, [], []

    async def user(name, secret, first):
        messenger = A.messenger.Messenger(debounce_s=math.inf)
        app = A.app.ClientApp(config_dir=tmp / name / "cfg",
                              data_dir=tmp / name / "data",
                              server_addr=addr, backend=backend(),
                              messenger=messenger, root_secret=secret,
                              tls=False, status_port=0)
        app.store.set_obfuscation_key(OBF)
        apps.append(app)
        await app.start()
        if first:
            app.store.add_peer_negotiated(holder.id, GRANT)
            holder.store.add_peer_negotiated(app.client_id, GRANT)
            server.db.save_storage_negotiated(app.client_id, holder.id,
                                              GRANT)
        ui = A.ui.UIServer(app, bind="127.0.0.1:0")
        uis.append(ui)
        url = await ui.start()
        return app, url

    try:
        app, url = await user("owner", SECRET, True)
        phrase = A.crypto.secret_to_phrase(app.keys.root_secret)
        async with aiohttp.ClientSession() as http:
            async with http.ws_connect(url + "/ws") as ws:
                facts["get_config"] = await _drive(ws, "get_config",
                                                   "config")
                facts["config"] = await _drive(
                    ws, "config", "config", backup_path=str(tree))
                done = await _drive(ws, "start_backup", "backup_finished")
            facts["root"] = done[-1][1]["snapshot"]
            async with http.get(f"http://127.0.0.1:{app.status_port}"
                                "/healthz") as resp:
                facts["healthz"] = _keys(await resp.json())
        names = {}
        for h, pid in app.engine.index.blob_map().items():
            names.setdefault(bytes(pid), []).append(bytes(h))
        names = {pid: hashlib.sha256(b"".join(sorted(hs))).hexdigest()[:16]
                 for pid, hs in names.items()}
        facts["store"] = _store_rows(app.store, names)
        facts["events"] = _events(app.messenger, tmp, names)
        # a lost machine: the identity from its phrase, a fresh store
        lost, url = await user("lost", A.crypto.parse_recovery(phrase),
                               False)
        dest = tmp / "restored"
        async with aiohttp.ClientSession() as http:
            async with http.ws_connect(url + "/ws") as ws:
                await _drive(ws, "config", "config", backup_path=str(dest))
                await _drive(ws, "start_restore", "restore_finished")
        facts["restored"] = _digest(dest)
        facts["restore_events"] = _events(lost.messenger, tmp, names)
    finally:
        for ui in uis:
            await ui.stop()
        for app in apps:
            await app.stop()
        await holder.close()
        await server.stop()
    return facts


def test_client_app_parity(tmp_path, monkeypatch):
    """Tolerance 0 between the port's ``ClientApp`` over
    ``GpuBackend(device="cpu")`` and the reference's over ``CpuBackend``
    (see the module's docstring)."""
    monkeypatch.setenv("BKW_BACKUP_PHASED", "1")
    for pkg in (PORT, REF):
        monkeypatch.setattr(_modules(pkg).defaults, "PACK_EMIT_MAX_LAG_S",
                            float("inf"))
    tree = _tree(tmp_path / "tree")
    got = {}
    for pkg in (REF, PORT):
        loop = asyncio.new_event_loop()
        try:
            got[pkg] = loop.run_until_complete(asyncio.wait_for(
                _user(tmp_path / pkg, pkg, tree), 120))
        finally:
            loop.close()
    want, port = got[REF], got[PORT]
    assert port["restored"] == _digest(tree)
    for key in ("root", "restored", "store", "events", "restore_events",
                "get_config", "config", "healthz"):
        if isinstance(want[key], list):
            for i, (a, b) in enumerate(zip(port[key], want[key])):
                assert a == b, (key, i)
        assert port[key] == want[key], key
    kinds = [k for k, _p in port["events"]]
    assert "backup_finished" in kinds and "transfer" in kinds
    assert port["store"]["placements"] and port["store"]["snapshots"]


def test_explain_and_timeline_parity(tmp_path):
    """``obs.diagnose.explain`` over one seeded series and event window,
    and ``obs.timeline.export_timeline`` over one seeded pair of journals:
    the port's report equals the reference's, its document is the
    reference's byte for byte."""
    import importlib

    rng = random.Random(5)
    reports = {}
    for pkg in (PORT, REF):
        series = importlib.import_module(f"{pkg}.obs.series")
        slo = importlib.import_module(f"{pkg}.obs.slo")
        diagnose = importlib.import_module(f"{pkg}.obs.diagnose")
        rec = series.SeriesRecorder(())
        r = random.Random(11)
        for t in range(900, 1000):
            rec.record("bkw_noise", r.gauss(5.0, 0.5) if t != 997 else 40.0,
                       t=float(t))
            rec.record("bkw_viol_total", float(t // 7), t=float(t),
                       kind="counter")
        events = [{"ts": 990.0 + i / 3, "kind": k, "site": f"s{i % 3}",
                   "peer": f"{i:08x}"}
                  for i, k in enumerate(["fault", "fault", "durability",
                                         "placement_demotion", "fault",
                                         "audit_failed"] * 2)]
        breach = slo.Breach(objective="viol", t=1000.0, status="violated",
                            prev_status="ok", burns={"4s": 20.0},
                            window_s=12.0)
        reports[pkg] = diagnose.explain(breach, recorder=rec, events=events)
    assert reports[PORT] == reports[REF]
    assert reports[PORT]["causes"]

    journals = []
    for name in ("owner", "holder"):
        lines = []
        for i in range(40):
            trace = f"t{rng.randrange(4)}"
            if rng.random() < 0.6:
                lines.append({"ts": 100.0 + i * 0.25, "kind": "span",
                              "name": rng.choice(["engine.backup",
                                                  "packer.seal",
                                                  "receiver.store"]),
                              "trace_id": trace, "span_id": f"{name}{i}",
                              "parent_id": None,
                              "dur_s": rng.random() / 4})
            else:
                lines.append({"ts": 100.0 + i * 0.25, "kind": "status",
                              "trace_id": trace, "event": "progress"})
        path = tmp_path / f"{name}.jsonl"
        path.write_text("".join(json.dumps(x) + "\n" for x in lines)
                        + "{torn\n")
        journals.append(path)
    docs = {}
    for pkg in (PORT, REF):
        timeline = importlib.import_module(f"{pkg}.obs.timeline")
        out = tmp_path / pkg / "timeline.json"
        timeline.export_timeline(journals, out)
        docs[pkg] = out.read_bytes()
        for trace in ("t1", "t3"):
            cut = tmp_path / pkg / f"{trace}.json"
            timeline.export_timeline(journals, cut, trace_id=trace,
                                     labels=["a", "b"])
            docs[pkg] += cut.read_bytes()
    assert docs[PORT] == docs[REF]
    assert b"engine.backup" in docs[PORT]
