#!/usr/bin/env python3
"""Timing trial of the CDC candidate scan's gear lookup on one card.

    python3 scripts/torch_k1_variants.py [--reps N]

Builds ``scripts/torch_k1_variants.cu`` (the port's scan kernel with the
gear value taken from fmix32, from one shared 256-entry table or from 32
per-lane copies of it, plus the staging phase alone) into
``build/k1_variants/``, checks each full variant bit-exact against the
port's ``scan_fused.candidate_words`` on a 1 x 128 MiB row, 16 x 8 MiB
rows and ragged rows, and prints CUDA-event medians beside the port's
kernel, twice in turns, with ``cuobjdump -sass`` instruction counts and
the card's name and power limit.  Not part of the port.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

VARIANTS = {"fmix32": 0, "one table": 1, "32 lane tables": 2,
            "staging only": 3}


def build() -> Path:
    from backuwup_tpu_torch import kernels

    out = REPO / "build" / "k1_variants"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libtorch_k1_variants.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS,
                    str(REPO / "scripts" / "torch_k1_variants.cu"), "-o",
                    str(lib)], check=True, capture_output=True, timeout=600)
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from backuwup_tpu_torch.ops import scan_fused
    from backuwup_tpu_torch.ops.cdc_gpu import _HALO
    from backuwup_tpu_torch.ops.gear import CDCParams

    path = build()
    cs.log_sass(path.parent, ("torch_k1_variants",))
    lib = ctypes.CDLL(str(path))
    vp = ctypes.c_void_p
    lib.bkw_scan_variant.argtypes = [ctypes.c_int, vp, vp, vp, vp,
                                     ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_uint, ctypes.c_uint, vp]
    lib.bkw_scan_variant.restype = ctypes.c_int

    def run(mode, ext, nv, ms, ml):
        B, P = ext.shape[0], ext.shape[1] - _HALO
        wl = torch.empty((B, P // 32), dtype=torch.int32, device="cuda")
        ws = torch.empty_like(wl)
        rc = lib.bkw_scan_variant(mode, ext.data_ptr(), nv.data_ptr(),
                                  wl.data_ptr(), ws.data_ptr(), B, P, ms, ml,
                                  torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"variant {mode}: CUDA error {rc}")
        return wl, ws

    rng = np.random.default_rng(0)
    big_p, small_p = 128 << 20, 8 << 20
    row = torch.from_numpy(rng.integers(0, 256, big_p, dtype=np.uint8)).cuda()
    ext1 = torch.zeros((1, _HALO + big_p), dtype=torch.uint8, device="cuda")
    ext1[0, _HALO:] = row
    nv1 = torch.tensor([big_p - 12345], dtype=torch.int32, device="cuda")
    ext16 = torch.zeros((16, _HALO + small_p), dtype=torch.uint8,
                        device="cuda")
    ext16[:, _HALO:] = row.view(16, small_p)
    nv16 = torch.tensor([small_p - 777 * r for r in range(16)],
                        dtype=torch.int32, device="cuda")
    width = 31 + 32 * 13 + 32768
    ragged = torch.from_numpy(rng.integers(
        0, 256, 3 + 5 * width, dtype=np.uint8)).cuda()[3:].view(5, width)
    nvr = torch.tensor([0, 1, 31, 33, width - 31], dtype=torch.int32,
                       device="cuda")
    masks = [(CDCParams().mask_s, CDCParams().mask_l),
             (CDCParams.from_desired(64 * 1024).mask_s,
              CDCParams.from_desired(64 * 1024).mask_l),
             (0xF0000000, 0xC0000000)]
    for ext, nv in ((ext1, nv1), (ext16, nv16), (ragged, nvr)):
        for ms, ml in masks:
            want = scan_fused.candidate_words(ext, nv, ms, ml)
            for name, mode in VARIANTS.items():
                if name == "staging only":
                    continue
                got = run(mode, ext, nv, ms, ml)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{name} disagrees: B="
                                         f"{ext.shape[0]} masks {ms:#x}")
    print("every full variant bit-exact with scan_fused.candidate_words")
    ms, ml = masks[0]
    for turn in range(2):
        t1 = cs.cuda_ms(torch, lambda: scan_fused.candidate_words(
            ext1, nv1, ms, ml), reps=args.reps)
        t16 = cs.cuda_ms(torch, lambda: scan_fused.candidate_words(
            ext16, nv16, ms, ml), reps=args.reps)
        print(f"turn {turn}: port kernel 1x128MiB {t1:.4f} ms, 16x8MiB "
              f"{t16:.4f} ms")
        for name, mode in VARIANTS.items():
            t1 = cs.cuda_ms(torch, lambda: run(mode, ext1, nv1, ms, ml),
                            reps=args.reps)
            t16 = cs.cuda_ms(torch, lambda: run(mode, ext16, nv16, ms, ml),
                             reps=args.reps)
            print(f"turn {turn}: {name} 1x128MiB {t1:.4f} ms, 16x8MiB "
                  f"{t16:.4f} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    os.chdir(REPO)
    sys.exit(main())
