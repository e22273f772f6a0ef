"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, under ``build/kernels/<hash>/`` at the
repository root (git-ignored), and loaded with ``ctypes``.  The hash
covers every source and the compiler flags, so a changed ``.cu`` builds
anew.  Nothing is built when the package is imported: the first launch
builds, or :func:`build_all` does it up front, one ``nvcc`` per source,
all started together.  A build that fails raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points of each library: (argument types, return type)
_P = ctypes.c_void_p
SIGNATURES = {
    "scan_candidates": {
        "bkw_scan_candidates": ([_P, _P, _P, _P, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_uint,
                                 ctypes.c_uint, _P], ctypes.c_int),
    },
    "blake3_leaf": {
        "bkw_blake3_leaf": ([_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P],
                            ctypes.c_int),
    },
    "gear_values": {
        "bkw_gear_values": ([_P, _P, ctypes.c_longlong, _P], ctypes.c_int),
    },
    "ladder_candidates": {
        "bkw_ladder_candidates": ([_P, _P, _P, ctypes.c_longlong,
                                   ctypes.c_longlong, ctypes.c_uint,
                                   ctypes.c_uint, _P], ctypes.c_int),
    },
    "gf_matmul": {
        "bkw_gf_matmul": ([_P, _P, _P, ctypes.c_int, ctypes.c_int,
                           ctypes.c_longlong, ctypes.c_longlong, _P],
                          ctypes.c_int),
    },
    "dedup_probe": {
        "bkw_dedup_probe": ([_P, _P, _P, ctypes.c_longlong, ctypes.c_uint,
                             ctypes.c_uint, ctypes.c_int, _P, _P],
                            ctypes.c_int),
        "bkw_dedup_insert": ([_P, _P, _P, _P, ctypes.c_longlong,
                              ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
                              ctypes.c_int, _P, _P, _P, _P, _P, _P, _P],
                             ctypes.c_int),
        "bkw_dedup_migrate": ([_P, _P, ctypes.c_longlong, ctypes.c_uint,
                               _P, _P, ctypes.c_uint, ctypes.c_longlong,
                               ctypes.c_int, _P, _P, _P, _P, _P],
                              ctypes.c_int),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def build_dir() -> Path:
    """``build/kernels/<hash of sources + flags>``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build_all() -> Dict[str, str]:
    """Compile every missing library in parallel; returns name -> ptxas
    report (empty for a library that was already built).  Raises with the
    compiler's output when any build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SIGNATURES:
        dst = _lib_path(name)
        if dst.exists():
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, dst)
    reports = {name: "" for name in SIGNATURES}
    failed = []
    for name, (proc, tmp, dst) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, dst)  # atomic: a reader never sees a partial .so
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _lib_path(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _libs[name] = lib
        return lib


def check_launch(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
