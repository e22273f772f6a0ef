"""The PyTorch port stands alone: no JAX, no ``backuwup_tpu``, no silent CPU.

``backuwup_tpu_torch`` starts with ``backuwup_tpu``, so module names are
matched exactly (or by a dotted prefix), never by string prefix.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "backuwup_tpu_torch"
FORBIDDEN = ("jax", "backuwup_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_imports_in_port_sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert bad == []
    # the exact-name rule must not confuse the port with the reference
    assert not _forbidden("backuwup_tpu_torch.ops")
    assert _forbidden("backuwup_tpu.ops") and _forbidden("jax.numpy")


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    mods = sorted(
        ".".join(("backuwup_tpu_torch",) + p.relative_to(PORT).with_suffix(
            "").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'backuwup_tpu' or m.startswith('backuwup_tpu.')]\n"
            "assert bad == [], bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_without_cuda_raise(monkeypatch):
    from backuwup_tpu_torch.ops.backend import GpuBackend, select_backend
    from backuwup_tpu_torch.ops.pipeline import DevicePipeline
    from backuwup_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (GpuBackend, select_backend, lambda: select_backend("gpu"),
                 DevicePipeline, resolve_device,
                 lambda: resolve_device("cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # asked for, the CPU runs the plain versions
    assert GpuBackend(device="cpu").device.type == "cpu"
    assert select_backend("cpu").name == "cpu"
