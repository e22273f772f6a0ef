#!/usr/bin/env python3
"""Timing trial of the gear-value (K3) and flat-ladder (K4) kernels on one
card.

    python3 scripts/torch_k3k4_variants.py [--reps N]

Builds ``scripts/torch_k3k4_variants.cu`` (variants of the port's
``csrc/gear_values.cu`` and ``csrc/ladder_candidates.cu``, and both
kernels as the port had them before their redesign) into
``build/k3k4_variants/``, checks every variant bit-exact against the
port's kernels (K3 on 128 MiB at byte offsets 0 and 12345 and on short
inputs at offsets 0-3; K4 on 128 Mi positions and on one ladder block with
n_valid at every boundary of the schedule), and prints CUDA-event medians
per launch of 20 back to back beside the port's kernels and a 640 MiB
``copy_``, twice in turns, with ``cuobjdump -sass`` instruction counts and
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

K3 = {"groups 8 + __stcs (port)": 0, "groups 4 + __stcs": 1,
      "groups 16 + __stcs": 2, "groups 8, plain stores": 3,
      "groups 8 + __stcs, 32 lane tables": 4, "before (PR 2 kernel)": 5,
      "old store pattern, new grid": 6}
K4 = {"run 16, 1 span (port)": 0, "run 8": 1, "run 32": 2,
      "4 spans per warp": 3, "16 spans per warp": 4, "run 16 + __stcs": 5,
      "before (PR 2 kernel)": 6}


def build() -> Path:
    from backuwup_tpu_torch import kernels

    out = REPO / "build" / "k3k4_variants"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libtorch_k3k4_variants.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS,
                    str(REPO / "scripts" / "torch_k3k4_variants.cu"), "-o",
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
    from backuwup_tpu_torch.ops import pallas_kernels as pk
    from backuwup_tpu_torch.ops.gear import CDCParams

    path = build()
    cs.log_sass(path.parent, ("torch_k3k4_variants",))
    lib = ctypes.CDLL(str(path))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.bkw_k3_variant.argtypes = [ctypes.c_int, vp, vp, ll, vp]
    lib.bkw_k4_variant.argtypes = [ctypes.c_int, vp, vp, vp, ll, ll,
                                   ctypes.c_uint, ctypes.c_uint, vp]
    lib.bkw_k3_variant.restype = lib.bkw_k4_variant.restype = ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def k3(mode, b):
        g = torch.empty(b.shape, dtype=torch.int32, device="cuda")
        rc = lib.bkw_k3_variant(mode, b.data_ptr(), g.data_ptr(), b.numel(),
                                stream())
        if rc:
            raise RuntimeError(f"K3 variant {mode}: CUDA error {rc}")
        return g

    def k4(mode, g, n_valid, ms, ml):
        cl = torch.empty(g.shape, dtype=torch.uint8, device="cuda")
        cs_ = torch.empty_like(cl)
        rc = lib.bkw_k4_variant(mode, g.data_ptr(), cl.data_ptr(),
                                cs_.data_ptr(), g.numel(), n_valid, ms, ml,
                                stream())
        if rc:
            raise RuntimeError(f"K4 variant {mode}: CUDA error {rc}")
        return cl, cs_

    rng = np.random.default_rng(0)
    n = 128 << 20
    row = torch.from_numpy(rng.integers(0, 256, n + 16384,
                                        dtype=np.uint8)).cuda()
    aligned, odd = row[:n], row[12345:12345 + n]
    inputs3 = [aligned, odd] + [row[o:o + 4099] for o in range(4)]
    for b in inputs3:
        want = pk.gear_values(b)
        for name, mode in K3.items():
            if mode == 6 and (b.numel() % 16 or b.data_ptr() % 16):
                continue
            if not torch.equal(k3(mode, b), want):
                raise AssertionError(f"K3 {name} disagrees, n={b.numel()}")
    print("K3: every variant bit-exact with pallas_kernels.gear_values")

    n4 = 2049 * pk.LADDER_BLOCK  # 128 MiB behind 31 halo values, rounded up
    g = pk.gear_values(torch.from_numpy(rng.integers(
        0, 256, n4, dtype=np.uint8)).cuda())
    masks = [(CDCParams().mask_s, CDCParams().mask_l),
             (CDCParams.from_desired(64 * 1024).mask_s,
              CDCParams.from_desired(64 * 1024).mask_l),
             (0xF0000000, 0xC0000000)]
    g1 = g[:pk.LADDER_BLOCK]
    edges = [0, 1, 31, 33, pk.LADDER_BLOCK]
    for e in (8, 16, 32, 256, 512, 1024, 2048, 4096, 16384, 32768):
        edges += [e - 1, e, e + 1]
    cases = [(g, n4 - 54321)] + [(g1, e) for e in edges]
    for gg, nv in cases:
        for ms, ml in masks:
            want = pk.ladder_candidates(gg, nv, mask_s=ms, mask_l=ml)
            for name, mode in K4.items():
                got = k4(mode, gg, nv, ms, ml)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"K4 {name} disagrees, "
                                         f"n={gg.numel()} n_valid={nv}")
    print("K4: every variant bit-exact with pallas_kernels.ladder_candidates")

    ms, ml = masks[0]
    nv = n4 - 54321
    for turn in range(2):
        t = cs.cuda_ms(torch, lambda: pk.gear_values(aligned),
                       reps=args.reps, count=20)
        t_odd = cs.cuda_ms(torch, lambda: pk.gear_values(odd),
                           reps=args.reps, count=20)
        print(f"turn {turn}: K3 port kernel 128 MiB {t:.4f} ms, offset "
              f"12345 {t_odd:.4f} ms")
        for name, mode in K3.items():
            t = cs.cuda_ms(torch, lambda: k3(mode, aligned),
                           reps=args.reps, count=20)
            t_odd = ("-" if mode == 6 else "%.4f ms" % cs.cuda_ms(
                torch, lambda: k3(mode, odd), reps=args.reps, count=20))
            print(f"turn {turn}: K3 {name} 128 MiB {t:.4f} ms, offset "
                  f"12345 {t_odd}")
        t = cs.cuda_ms(torch, lambda: pk.ladder_candidates(
            g, nv, mask_s=ms, mask_l=ml), reps=args.reps, count=20)
        print(f"turn {turn}: K4 port kernel {n4} positions {t:.4f} ms")
        for name, mode in K4.items():
            t = cs.cuda_ms(torch, lambda: k4(mode, g, nv, ms, ml),
                           reps=args.reps, count=20)
            print(f"turn {turn}: K4 {name} {n4} positions {t:.4f} ms")
        src = torch.empty(cs.COPY_BYTES, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        t = cs.cuda_ms(torch, lambda: dst.copy_(src), reps=args.reps,
                       count=20)
        del src, dst
        print(f"turn {turn}: copy_ of {cs.COPY_BYTES >> 20} MiB {t:.4f} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    os.chdir(REPO)
    sys.exit(main())
