"""The port's process entry points: ``python -m backuwup_tpu_torch``.

The reference's own cases of ``tests/test_main.py`` and
``tests/test_subprocess_e2e.py`` run over the port's processes: each case is
the reference test function re-created (``rebind`` of
``tests/test_torch_net_server.py``) over a namespace whose ``subprocess``
starts ``python -m backuwup_tpu_torch`` where the case starts ``python -m
backuwup_tpu`` (:func:`processes`), and whose client processes run on the
CPU (``--device cpu``: the sandbox has no card).  The fixed ports of
``tests/test_main.py`` become free ones, so the case can run beside the
reference's own.  One cross-package case runs the reference's server
process with the port's clients.

On top of those: without CUDA and without ``--device cpu`` the client
exits non-zero with the missing-device message and makes no state; the
``server`` role loads no ``torch``.
"""

import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import pytest

import test_main as ref_main
import test_subprocess_e2e as ref_e2e
from test_torch_net_server import PORT, REF, cases, rebind, run_case

REPO = Path(__file__).resolve().parent.parent
# the reference's cases of test_main.py bind these ports
FIXED_PORTS = ("18100", "18101")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def processes(server_pkg, client_pkg):
    """A stand-in for the ``subprocess`` module whose ``Popen`` starts the
    ``server`` role of ``server_pkg`` and the ``client`` role of
    ``client_pkg`` where the argument list names the reference's package;
    the port's client gets ``--device cpu``."""
    def popen(args, *a, **kw):
        args = list(args)
        if args[1:3] == ["-m", REF]:
            role = args[3]
            pkg = server_pkg if role == "server" else client_pkg
            args[2] = pkg
            if pkg == PORT and role == "client":
                args += ["--device", "cpu"]
        return subprocess.Popen(args, *a, **kw)

    mod = types.ModuleType("subprocess_over_packages")
    mod.__dict__.update(vars(subprocess))
    mod.Popen = popen
    return mod


def _free_ports(fn, ports):
    """``fn`` with each of :data:`FIXED_PORTS` in its string constants
    replaced by the matching one of ``ports``."""
    def code_over(code):
        consts = []
        for c in code.co_consts:
            if isinstance(c, str):
                for old, new in zip(FIXED_PORTS, ports):
                    c = c.replace(old, str(new))
            elif isinstance(c, types.CodeType):
                c = code_over(c)
            consts.append(c)
        return code.replace(co_consts=tuple(consts))

    return types.FunctionType(code_over(fn.__code__), fn.__globals__,
                              fn.__name__, fn.__defaults__, fn.__closure__)


PAIRS = {"port": (PORT, PORT), "ref-server-port-clients": (REF, PORT)}


def _ns(module, pair_name):
    server_pkg, client_pkg = PAIRS[pair_name]
    ns = rebind(module, lambda path: client_pkg)
    ns["subprocess"] = processes(server_pkg, client_pkg)
    return ns


def _params(module, pairs):
    return [pytest.param(*case.values, p, id=f"{p}-{case.id}")
            for case in cases(module) for p in pairs]


@pytest.mark.parametrize("name,params,pair_name", _params(ref_main, ["port"]))
def test_main_cases(name, params, pair_name, request):
    ns = _ns(ref_main, pair_name)
    ns[name] = _free_ports(ns[name], [_free_port() for _ in FIXED_PORTS])
    run_case(ref_main, ns, name, params, request)


@pytest.mark.parametrize("name,params,pair_name",
                         _params(ref_e2e, list(PAIRS)))
def test_subprocess_e2e_cases(name, params, pair_name, request):
    run_case(ref_e2e, _ns(ref_e2e, pair_name), name, params, request)


def test_cases_were_found():
    assert [len(cases(m)) for m in (ref_main, ref_e2e)] == [2, 1]
    fn = _free_ports(ref_main.test_server_and_client_processes,
                     [40001, 40002])
    text = " ".join(c for c in fn.__code__.co_consts if isinstance(c, str))
    assert "40001" in text and "18100" not in text


def test_processes_start_the_package_asked_for():
    """The stand-in's argument lists: the port's client on the CPU, each
    role from its package, anything else untouched."""
    seen = []

    class Recorder:
        def __init__(self, args, *a, **kw):
            seen.append(args)

    mod = processes(REF, PORT)
    mod_popen = mod.Popen
    real, subprocess.Popen = subprocess.Popen, Recorder
    try:
        mod_popen([sys.executable, "-m", REF, "client", "--x"])
        mod_popen([sys.executable, "-m", REF, "server", "--bind", "a:1"])
        mod_popen([sys.executable, "-c", "pass"])
    finally:
        subprocess.Popen = real
    assert seen == [
        [sys.executable, "-m", PORT, "client", "--x", "--device", "cpu"],
        [sys.executable, "-m", REF, "server", "--bind", "a:1"],
        [sys.executable, "-c", "pass"]]


def test_client_without_cuda_exits_and_says_so(tmp_path):
    """No silent CPU: without a card and without ``--device cpu`` the
    client exits non-zero, names the missing device, and writes no
    state (no identity, no store)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", PORT, "client", "--non-interactive",
         "--config-dir", str(tmp_path / "cfg"),
         "--data-dir", str(tmp_path / "data"),
         "--server-addr", "127.0.0.1:9", "--ui-bind", "127.0.0.1:0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and "--device cpu" in res.stderr
    assert "RECOVERY PHRASE" not in res.stdout
    assert not (tmp_path / "cfg").exists()
    assert not (tmp_path / "data").exists()


def test_server_role_loads_no_torch():
    """The ``server`` role runs no kernel: its entry point and the
    coordination server import no ``torch``."""
    code = ("import sys\n"
            f"import {PORT}.__main__ as m\n"
            f"from {PORT}.net import server\n"
            "assert m.main and server.CoordinationServer\n"
            "assert 'torch' not in sys.modules, 'torch loaded'\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
