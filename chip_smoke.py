#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port's manifest plane on one card.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``backuwup_tpu_torch/csrc`` and runs:

1. build + device: ``nvcc`` build time; the card's name and power limit;
2. each kernel against its plain PyTorch version on the card at the main
   path's full width, bit-exact, with CUDA-event times (median of 7 after
   warm-up) beside the kernel's bound;
3. the main path: ``GpuBackend().manifest_many`` over a seeded ~2.5 GiB
   corpus (one-row 128 MiB batches, multi-row batches, tiny files and a
   long file of repeated blocks) with ``strict_overflow`` and the default
   chunking, then a 256 MiB part with 64 KiB chunks; launch counts of
   every kernel over each run, end-to-end MiB/s; then device time by
   kernel over two profiled calls (one-row batches; multi-row + tiny);
4. oracle parity: a subset covering every route (tiny, multi-row, a long
   stream over small segments) plus the main path's largest shapes (one
   96 MiB one-row batch, the 304 MiB long stream) held equal to the
   port's ``cdc_cpu`` + ``blake3_cpu`` oracles.

Prints a ``{"kernels": [...]}`` JSON line and, last, the device line.
Exits non-zero, printing no result, without CUDA or without the package.
Imports nothing of JAX or of ``backuwup_tpu``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
MiB = 1 << 20

# H100 SXM data-sheet rates: HBM3 bandwidth, and 32-bit integer
# instructions (132 SMs x 64 INT32 lanes x ~1.98 GHz boost); neither kernel
# uses the tensor cores, so the integer issue rate is the operations ceiling.
# Operations are counted as the fewest instructions sm_90 issues for them
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# per stream position of the candidate scan: gear fmix32 (9: add, 3 shifts,
# 3 xors, 2 multiplies), five doubling passes of a + (b << s) (5 fused
# shift-adds), two masks, their tests, the valid check and the ballots (~7)
SCAN_OPS_PER_POS = 9 + 5 + 7
# per BLAKE3 compression: 7 rounds x 8 G x 12 (2 three-input adds, 2 adds,
# 4 xors, 4 funnel shifts) + 8 output xors
B3_OPS_PER_BLOCK = 7 * 8 * 12 + 8


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int = 7, warm: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in ms."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(torch, got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        d = (g.to(torch.int64) & 0xFFFFFFFF) - (w.to(torch.int64) & 0xFFFFFFFF)
        err = max(err, int(d.abs().max()))
    return err


def phase_kernels(torch, rng, card):
    """Each kernel vs its plain version on the card; returns JSON rows."""
    from backuwup_tpu_torch.ops import blake3_gpu, scan_fused
    from backuwup_tpu_torch.ops.cdc_gpu import _HALO, scan_select_batch
    from backuwup_tpu_torch.ops.digest_pool import leaf_capacity, leaf_plan
    from backuwup_tpu_torch.ops.gear import CDCParams
    from backuwup_tpu_torch.ops.manifest_device import _chunk_meta
    from backuwup_tpu_torch.ops.pipeline import DevicePipeline

    dev = torch.device("cuda")
    big_p = 128 * MiB
    row = rng.integers(0, 256, big_p, dtype=np.uint8)
    ext1 = torch.zeros((1, _HALO + big_p), dtype=torch.uint8, device=dev)
    ext1[0, _HALO:] = torch.from_numpy(row).to(dev)
    nv1 = torch.tensor([big_p - 12345], dtype=torch.int32, device=dev)
    small_p = 8 * MiB
    ext16 = torch.zeros((16, _HALO + small_p), dtype=torch.uint8, device=dev)
    ext16[:, _HALO:] = torch.from_numpy(
        row[:16 * small_p].reshape(16, small_p)).to(dev)
    nv16 = torch.tensor([small_p - 777 * r for r in range(16)],
                        dtype=torch.int32, device=dev)
    nv16[5] = 0
    nv16[6] = 33
    masks = [(CDCParams().mask_s, CDCParams().mask_l),
             (CDCParams.from_desired(64 * 1024).mask_s,
              CDCParams.from_desired(64 * 1024).mask_l)]
    err = 0
    for ext, nv in ((ext1, nv1), (ext16, nv16)):
        for ms, ml in masks:
            got = scan_fused.candidate_words(ext, nv, ms, ml)
            want = scan_fused.candidate_words_plain(ext, nv, ms, ml)
            torch.cuda.synchronize()
            e = max_abs_err(torch, got, want)
            log(f"K1 scan_candidates B={ext.shape[0]} P={ext.shape[1] - _HALO}"
                f" masks=({ms:#x},{ml:#x}) bit-exact={e == 0}")
            err = max(err, e)
    if err:
        raise AssertionError("scan kernel disagrees with its plain version")
    ms, ml = masks[0]
    k1_ms = cuda_ms(torch, lambda: scan_fused.candidate_words(ext1, nv1, ms, ml))
    k1_plain = cuda_ms(torch, lambda: scan_fused.candidate_words_plain(
        ext1, nv1, ms, ml), reps=5, warm=1)
    k1_b16 = cuda_ms(torch, lambda: scan_fused.candidate_words(
        ext16, nv16, ms, ml))
    k1_bound, k1_by = bound_ms(ext1.numel() + 4 + 2 * big_p // 8,
                               big_p * SCAN_OPS_PER_POS)
    log(f"K1 time 1x128MiB: kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms, "
        f"bound {k1_bound:.4f} ms ({k1_by}); 16x8MiB kernel {k1_b16:.4f} ms "
        f"[{card}]")
    del ext16

    # K2 on a 131,072-lane pool planned from real chunks of a 128 MiB row
    # (64 KiB chunking: many chunk tails, so nb / lbl / counters are mixed)
    p64 = CDCParams.from_desired(64 * 1024)
    s_cap, l_cap, cut_cap = DevicePipeline(p64, device=dev)._caps(big_p)
    ext1[0, _HALO + big_p - 12345:] = 0
    packed = scan_select_batch(
        ext1, nv1, min_size=p64.min_size, desired_size=p64.desired_size,
        max_size=p64.max_size, mask_s=p64.mask_s, mask_l=p64.mask_l,
        s_cap=s_cap, l_cap=l_cap, cut_cap=cut_cap)
    offs, lens, _ = _chunk_meta(packed, ext1.shape[1])
    flat = torch.cat([ext1.reshape(-1), ext1.new_zeros(1024)])
    plan = leaf_plan(flat, offs, lens, leaf_capacity(big_p, cut_cap))
    lanes = 131_072
    w, nb, lbl, ctr = (plan[k][:lanes].contiguous()
                       for k in ("words", "nb", "lbl", "counter"))
    log(f"K2 pool: {lanes} lanes, nb<16 on {int((nb < 16).sum())}, "
        f"distinct lbl {int(torch.unique(lbl).numel())}, "
        f"max counter {int(ctr.max())}")
    got = blake3_gpu.leaf_scan(w, nb, lbl, ctr)
    want = blake3_gpu.leaf_scan_plain(w, nb, lbl, ctr)
    torch.cuda.synchronize()
    e2 = max_abs_err(torch, got, want)
    log(f"K2 blake3_leaf lanes={lanes} bit-exact={e2 == 0}")
    if e2:
        raise AssertionError("leaf kernel disagrees with its plain version")
    k2_ms = cuda_ms(torch, lambda: blake3_gpu.leaf_scan(w, nb, lbl, ctr))
    k2_plain = cuda_ms(torch, lambda: blake3_gpu.leaf_scan_plain(
        w, nb, lbl, ctr), reps=5, warm=1)
    k2_bound, k2_by = bound_ms(lanes * (1024 + 12 + 64),
                               int(nb.to(torch.int64).sum()) * B3_OPS_PER_BLOCK)
    log(f"K2 time: kernel {k2_ms:.4f} ms, plain {k2_plain:.4f} ms, "
        f"bound {k2_bound:.4f} ms ({k2_by}) [{card}]")
    log("library_ms: null for both kernels -- no PyTorch call computes the "
        "gear candidate scan or the BLAKE3 leaf chain")
    return [
        {"name": "scan_candidates", "route": "cuda",
         "source": "backuwup_tpu_torch/csrc/scan_candidates.cu",
         "replaces": "backuwup_tpu/ops/scan_fused.py:64; "
                     "backuwup_tpu/ops/scan_fused.py:193",
         "max_abs_err": err, "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "blake3_leaf", "route": "cuda",
         "source": "backuwup_tpu_torch/csrc/blake3_leaf.cu",
         "replaces": "backuwup_tpu/ops/blake3_tpu.py:278",
         "max_abs_err": e2, "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None},
    ]


def make_corpus(rng):
    """~2.5 GiB of seeded streams covering every route of the driver."""
    files = [rng.bytes(96 * MiB) for _ in range(8)]           # 1-row batches
    sizes = np.exp(rng.uniform(np.log(256 * 1024 + 1), np.log(16 * MiB), 300))
    files += [rng.bytes(int(n)) for n in sizes]               # multi-row
    files += [rng.bytes(int(n)) for n in rng.integers(1, 256 * 1024 + 1, 2000)]
    block = rng.bytes(8 * MiB)
    files.append(block * 38)                                   # long path
    return files


def check_manifest(refs, data, params) -> None:
    pos = 0
    for r in refs:
        if r.offset != pos or not 0 < r.length <= params.max_size \
                or len(r.hash) != 32:
            raise AssertionError("malformed manifest")
        pos += r.length
    if pos != len(data):
        raise AssertionError("manifest does not cover its stream")


def run_main(torch, backend, streams, counters, label, card):
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = backend.manifest_many(streams)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    total = sum(len(s) for s in streams)
    pipe = backend.pipeline
    log(f"{label}: {len(streams)} streams, {total / MiB:.1f} MiB in "
        f"{secs:.3f} s = {total / MiB / secs:.1f} MiB/s end to end; "
        f"launches {launches}; oracle re-runs {pipe.oracle_reruns}, pool "
        f"re-runs {pipe.pool_reruns} [{card}]")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} not launched on the main path")
    if pipe.oracle_reruns or pipe.pool_reruns:
        raise AssertionError("overflow re-runs on the main path")
    for refs, data in zip(out, streams):
        check_manifest(refs, data, backend.params)
    return out, launches


def breakdown(torch, backend, streams, label, card) -> None:
    """Device time by kernel over one profiled ``manifest_many`` call:
    the scan and leaf kernels, copies, and the plain torch ops around
    them, with the device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        backend.manifest_many(streams)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {"scan_candidates": 0.0, "blake3_leaf": 0.0, "memcpy": 0.0,
              "torch ops": 0.0}
    launches = 0
    top = []
    for e in prof.key_averages():
        # device-side rows only: an aten op's row repeats its kernels' time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = float(getattr(e, "self_device_time_total", 0.0)
                  or getattr(e, "self_cuda_time_total", 0.0) or 0.0)
        if t <= 0:
            continue
        name = e.key
        if "scan_candidates_kernel" in name:
            g = "scan_candidates"
        elif "blake3_leaf_kernel" in name:
            g = "blake3_leaf"
        elif "memcpy" in name.lower() or "memset" in name.lower():
            g = "memcpy"
        else:
            g = "torch ops"
            launches += e.count
        groups[g] += t
        top.append((t, e.count, name[:60]))
    busy = sum(groups.values())
    if busy <= 0:
        log(f"breakdown {label}: device time not measured (the profiler "
            "reported none)")
        return
    total = sum(len(s) for s in streams)
    log(f"breakdown {label}: {total / MiB:.1f} MiB, wall {wall_us / 1e3:.1f} "
        f"ms (profiled), device busy {busy / 1e3:.1f} ms = "
        f"{100 * busy / wall_us:.1f}% of wall, idle "
        f"{100 * (1 - busy / wall_us):.1f}% [{card}]")
    for g, t in groups.items():
        log(f"  {g}: {t / 1e3:.2f} ms ({100 * t / busy:.1f}% of device time)")
    log(f"  torch-op kernel launches: {launches}")
    for t, n, name in sorted(top, reverse=True)[:8]:
        log(f"  top: {t / 1e3:8.2f} ms x{n:6d} {name}")


def oracle_manifest(data, params):
    from backuwup_tpu_torch.ops import blake3_cpu, cdc_cpu

    chunks = cdc_cpu.chunk_stream(data, params)
    digs = blake3_cpu.blake3_many([data[o:o + n] for o, n in chunks])
    return [(o, n, h) for (o, n), h in zip(chunks, digs)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (HERE / "backuwup_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: backuwup_tpu_torch is missing beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from backuwup_tpu_torch import kernels
    from backuwup_tpu_torch.ops import blake3_gpu, scan_fused
    from backuwup_tpu_torch.ops.backend import GpuBackend
    from backuwup_tpu_torch.ops.gear import CDCParams

    # 1. build + device
    t0 = time.perf_counter()
    reports = kernels.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s into {kernels.build_dir()}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if any(k in line for k in ("registers", "spill", "stack frame")):
                log(f"ptxas {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    rng = np.random.default_rng(args.seed)
    # 2. kernels vs plain at full width
    rows = phase_kernels(torch, rng, card)
    torch.cuda.empty_cache()

    # 3. the main path at real size
    counters = {"scan_candidates": scan_fused.candidate_words,
                "blake3_leaf": blake3_gpu.leaf_scan}
    t0 = time.perf_counter()
    corpus = make_corpus(rng)
    log(f"corpus: {len(corpus)} files, "
        f"{sum(map(len, corpus)) / MiB:.1f} MiB, made in "
        f"{time.perf_counter() - t0:.1f} s")
    backend = GpuBackend(strict_overflow=True)
    main_out, launches = run_main(torch, backend, corpus, counters,
                                  "main path, CDCParams() 256K/1M/3M", card)
    for row in rows:
        row["launches"] = launches[row["name"]]
    part, size = [], 0
    for s in corpus[:2] + corpus[8:308]:
        if size >= 256 * MiB:
            break
        part.append(s)
        size += len(s)
    run_main(torch, GpuBackend(CDCParams.from_desired(64 * 1024),
                               strict_overflow=True),
             part, counters, "64 KiB chunks (from_desired(65536))", card)
    breakdown(torch, backend, corpus[:2], "2 one-row 96 MiB files", card)
    breakdown(torch, backend, corpus[8:48] + corpus[308:508],
              "40 multi-row + 200 tiny files", card)

    # 4. oracle parity on a >= 16 MiB subset covering every route
    params = backend.params
    multi = [i for i in range(8, 308)
             if 256 * 1024 < len(corpus[i]) <= 512 * 1024]
    tiny = list(range(308, 348))
    checked = 0
    for i in multi + tiny:
        got = [(r.offset, r.length, r.hash) for r in main_out[i]]
        if got != oracle_manifest(corpus[i], params):
            raise AssertionError(f"stream {i} differs from the oracle")
        checked += len(corpus[i])
    long_be = GpuBackend(strict_overflow=True)
    long_be.pipeline.scanner.segment_size = 8 * MiB
    long_data = rng.bytes(20 * MiB) + corpus[0][:4 * MiB]
    got = [(r.offset, r.length, r.hash)
           for r in long_be.manifest_many([long_data])[0]]
    if got != oracle_manifest(long_data, params):
        raise AssertionError("long-path stream differs from the oracle")
    checked += len(long_data)
    # the main path's largest shapes: a one-row 128 MiB batch (pool tiers
    # up to the 3072-leaf span) and the 304 MiB stream over 128 MiB segments
    t0 = time.perf_counter()
    for i in (0, len(corpus) - 1):
        got = [(r.offset, r.length, r.hash) for r in main_out[i]]
        if got != oracle_manifest(corpus[i], params):
            raise AssertionError(f"stream {i} differs from the oracle")
        checked += len(corpus[i])
    log(f"oracle parity: {len(multi)} batched (one 512 KiB bucket), "
        f"{len(tiny)} tiny, 1 long-path stream (8 MiB segments), one "
        f"96 MiB one-row batch and the 304 MiB long stream of the main "
        f"path: {checked / MiB:.1f} MiB bit-identical (the last two in "
        f"{time.perf_counter() - t0:.1f} s)")
    if checked < 16 * MiB or len(multi) < 2:
        raise AssertionError("parity subset too small")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
