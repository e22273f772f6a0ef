#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port's manifest plane on one card.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``backuwup_tpu_torch/csrc`` and runs:

1. build + device: ``nvcc`` build time; the card's name and power limit;
2. each kernel against its plain PyTorch version on the card at the main
   path's full width, bit-exact, with CUDA-event times (median of 7 after
   warm-up) beside the kernel's bound: K1 scan (1 x 128 MiB and 16 x 8
   MiB) and K2 leaf; K3 gear
   values (128 MiB at byte offsets 0, 2, 3 and 12345 and an odd length,
   timed aligned and at offset 12345, beside ``gear_t[b.long()]`` and a
   640 MiB ``copy_`` as the card's reachable bandwidth) and K4
   flat-ladder candidates (128 Mi positions, both mask pairs, and the
   ``cdc_cpu`` oracle on the first 8 MiB), whose path is their own entry
   points; ``cuobjdump -sass`` instruction counts of K1, K3, K4 and K5;
   K5 the dedup table at a deployment's size (one 2^23-slot
   shard filled to load 0.5 by 64 insert batches, a 2^20-query probe
   batch, a 2^21 -> 2^23 growth), every classification held against a
   host oracle and the first and last two batches, the probe and the
   growth against the plain version, whole tables bit-identical; each
   insert call's time and the rounds its one kernel launch ran;
3. the main path: ``GpuBackend().manifest_many`` over a seeded ~2.6 GiB
   corpus (one-row 128 MiB batches, multi-row batches, tiny files,
   repeated files and a long file of repeated blocks) with
   ``strict_overflow`` and the default chunking, then a 256 MiB part with
   64 KiB chunks; launch counts of every kernel over each run, end-to-end
   MiB/s; then the classified main path,
   ``manifest_many_classified(corpus, MeshDedupIndex(authority))`` over
   the same corpus and part, twice each: the hints against the host
   oracle (first occurrence new, repeats duplicates; then all
   duplicates), the rounds each insert call ran (from an untimed repeat),
   and
   ``manifest_many`` once more over the corpus for a
   comparison not skewed by warm-up; then device time by kernel over
   three profiled calls
   (one-row batches; multi-row + tiny; the same, classified);
4. oracle parity: a subset covering every route (tiny, multi-row, a long
   stream over small segments) plus the main path's largest shapes (one
   96 MiB one-row batch, the 304 MiB long stream) held equal to the
   port's ``cdc_cpu`` + ``blake3_cpu`` oracles, run in up to 8 worker
   processes.

Prints a ``{"kernels": [...]}`` JSON line and, last, the device line.
Exits non-zero, printing no result, without CUDA or without the package.
Imports nothing of JAX or of ``backuwup_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
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
# per stream position of the candidate scan, the fewest instructions any
# correct design needs: the gear value as one lookup in a 256-entry shared
# table (a byte extract and one LDS; fmix32 in registers takes 9), one
# fused shift-add of the rolling form h = (h << 1) + g, two mask tests (an
# and-test each) and one pack step.  An LDS issues at 32 lanes per clock
# per SM, half the int32 rate, so at that rate it costs 2 and the count
# still covers it
SCAN_OPS_PER_POS = 2 + 1 + 2 + 1
# per BLAKE3 compression: 7 rounds x 8 G x 12 (2 three-input adds, 2 adds,
# 4 xors, 4 funnel shifts) + 8 output xors
B3_OPS_PER_BLOCK = 7 * 8 * 12 + 8
# per position of the flat-ladder candidates (from gear values), the fewest
# instructions any correct design needs: one fused shift-add of the rolling
# form h = (h << 1) + g, two and-tests (cs tests mask_l | mask_s at once,
# since cs = cl & ((h & mask_s) == 0)) and one flag pack per output.  At
# 5 per position the operations take ~0.04 ms for 128 Mi positions against
# the bytes' ~0.24 ms (4 B read, 2 B written), so the bound is the bytes'
LADDER_OPS_PER_POS = 1 + 2 + 2
# the copy yardstick: one device-to-device copy_ of this many bytes
COPY_BYTES = 640 * MiB
SECTOR = 32  # bytes of one DRAM sector: the unit of a random access


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int = 7, warm: int = 2, count: int = 1) -> float:
    """Median CUDA-event time of ``fn`` in ms.  With ``count`` > 1 the
    events enclose ``count`` calls back to back and the time is per call:
    the host enqueues each call while the one before runs, so the wrapper's
    own host time drops out of a kernel that runs longer than it."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(count):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / count)
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
        for mask_s, mask_l in masks:
            got = scan_fused.candidate_words(ext, nv, mask_s, mask_l)
            want = scan_fused.candidate_words_plain(ext, nv, mask_s, mask_l)
            torch.cuda.synchronize()
            e = max_abs_err(torch, got, want)
            log(f"K1 scan_candidates B={ext.shape[0]} P={ext.shape[1] - _HALO}"
                f" masks=({mask_s:#x},{mask_l:#x}) bit-exact={e == 0}")
            err = max(err, e)
    if err:
        raise AssertionError("scan kernel disagrees with its plain version")
    ms, ml = masks[0]
    k1_ms = cuda_ms(torch, lambda: scan_fused.candidate_words(ext1, nv1, ms, ml))
    k1_b16 = cuda_ms(torch, lambda: scan_fused.candidate_words(
        ext16, nv16, ms, ml))
    k1_plain = cuda_ms(torch, lambda: scan_fused.candidate_words_plain(
        ext1, nv1, ms, ml), reps=5, warm=1)
    k1_bound, k1_by = bound_ms(ext1.numel() + 4 + 2 * big_p // 8,
                               big_p * SCAN_OPS_PER_POS)
    b16_bound, _ = bound_ms(ext16.numel() + 64 + 16 * 2 * small_p // 8,
                            16 * small_p * SCAN_OPS_PER_POS)
    log(f"K1 time 1x128MiB: kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms, "
        f"bound {k1_bound:.4f} ms ({k1_by}, {k1_bound / k1_ms:.1%} of it); "
        f"16x8MiB kernel {k1_b16:.4f} ms, bound {b16_bound:.4f} ms "
        f"({b16_bound / k1_b16:.1%}) [{card}]")
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


def phase_gear_ladder(torch, rng, card):
    """K3 and K4 against their plain versions at 128 MiB, then their own
    path (the two entry points, counts zeroed before it); JSON rows."""
    from backuwup_tpu_torch.ops import cdc_cpu, pallas_kernels as pk
    from backuwup_tpu_torch.ops.gear import GEAR, CDCParams

    dev = torch.device("cuda")
    n = 128 * MiB
    row = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).to(dev)
    err3 = 0
    for b in (row, row[:n - 12345], row[12345:], row[2:], row[3:]):
        got = pk.gear_values(b)
        want = pk.gear_values_plain(b)
        torch.cuda.synchronize()
        e = max_abs_err(torch, [got], [want])
        log(f"K3 gear_values n={b.numel()} offset "
            f"{b.data_ptr() - row.data_ptr()} bit-exact={e == 0}")
        err3 = max(err3, e)
    if err3:
        raise AssertionError("gear kernel disagrees with its plain version")
    gear_t = torch.from_numpy(GEAR.view(np.int32)).to(dev)
    # K3 and K4 are timed per launch over 20 launches back to back: a
    # single call's events also hold the wrapper's ~0.03-0.05 ms of host
    # enqueue, which is a fifth of these kernels' time (the single-call
    # time, the method of K1, K2 and K5's rows, is logged beside it)
    k3_ms = cuda_ms(torch, lambda: pk.gear_values(row), count=20)
    odd = row[12345:]  # an input at an odd byte offset
    k3_odd = cuda_ms(torch, lambda: pk.gear_values(odd), count=20)
    k3_one = cuda_ms(torch, lambda: pk.gear_values(row))
    k3_plain = cuda_ms(torch, lambda: pk.gear_values_plain(row), reps=5,
                       warm=1)
    k3_lib = cuda_ms(torch, lambda: gear_t[row.long()], reps=5, warm=1)
    k3_bound, k3_by = bound_ms(5 * n, n)
    odd_bound, _ = bound_ms(5 * odd.numel(), odd.numel())
    log(f"K3 time 128 MiB, per launch of 20 back to back: kernel "
        f"{k3_ms:.4f} ms ({k3_bound / k3_ms:.1%} of bound), at byte offset "
        f"12345 {k3_odd:.4f} ms ({odd_bound / k3_odd:.1%} of its bound "
        f"{odd_bound:.4f} ms); one call {k3_one:.4f} ms; plain "
        f"{k3_plain:.4f} ms, "
        f"gear_t[b.long()] {k3_lib:.4f} ms, bound {k3_bound:.4f} ms "
        f"({k3_by}) [{card}]")
    # a yardstick, not a library_ms: the rate one copy_ reaches on this card
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = cuda_ms(torch, lambda: dst.copy_(src), count=20)
    copy_rate = 2 * COPY_BYTES / (copy_ms * 1e-3)
    del src, dst
    log(f"copy yardstick: copy_ of {COPY_BYTES // MiB} MiB, per copy of 20 "
        f"back to back {copy_ms:.4f} ms, "
        f"{copy_rate / 1e12:.3f} TB/s read + written "
        f"({copy_rate / HBM_BYTES_PER_S:.1%} of "
        f"{HBM_BYTES_PER_S / 1e12} TB/s); at that rate K3's 5 B per byte take "
        f"{5 * n / copy_rate * 1e3:.4f} ms [{card}]")

    # K4 on the gear values of a 128 MiB row behind 31 zero bytes, rounded
    # up to the ladder block; n_valid short of the end
    n4 = -(-(31 + n) // pk.LADDER_BLOCK) * pk.LADDER_BLOCK
    ext = torch.zeros(n4, dtype=torch.uint8, device=dev)
    ext[31:31 + n] = row
    g = pk.gear_values_plain(ext)
    n_valid = 31 + n - 54321
    masks = [(CDCParams().mask_s, CDCParams().mask_l),
             (CDCParams.from_desired(64 * 1024).mask_s,
              CDCParams.from_desired(64 * 1024).mask_l)]
    head = row[:8 * MiB - 31].cpu().numpy()
    h_ref = cdc_cpu.gear_hashes(head.tobytes(), prev_tail=bytes(31))
    err4 = 0
    for ms, ml in masks:
        got = pk.ladder_candidates(g, n_valid, mask_s=ms, mask_l=ml)
        want = pk.ladder_candidates_plain(g, n_valid, mask_s=ms, mask_l=ml)
        torch.cuda.synchronize()
        e = max_abs_err(torch, got, want)
        cl = got[0][31:8 * MiB].cpu().numpy().astype(bool)
        cs = got[1][31:8 * MiB].cpu().numpy().astype(bool)
        cl_ref = (h_ref & np.uint32(ml)) == 0
        cs_ref = cl_ref & ((h_ref & np.uint32(ms)) == 0)
        oracle = np.array_equal(cl, cl_ref) and np.array_equal(cs, cs_ref)
        log(f"K4 ladder_candidates n={n4} masks=({ms:#x},{ml:#x}) "
            f"bit-exact={e == 0}, cdc_cpu oracle on 8 MiB={oracle}, "
            f"loose {int(got[0].sum())} strict {int(got[1].sum())}")
        if e or not oracle:
            raise AssertionError("ladder kernel disagrees")
        err4 = max(err4, e)
    ms, ml = masks[0]
    k4_ms = cuda_ms(torch, lambda: pk.ladder_candidates(
        g, n_valid, mask_s=ms, mask_l=ml), count=20)
    k4_one = cuda_ms(torch, lambda: pk.ladder_candidates(
        g, n_valid, mask_s=ms, mask_l=ml))
    k4_plain = cuda_ms(torch, lambda: pk.ladder_candidates_plain(
        g, n_valid, mask_s=ms, mask_l=ml), reps=5, warm=1)
    k4_bound, k4_by = bound_ms(6 * n4, n4 * LADDER_OPS_PER_POS)
    log(f"K4 time {n4} positions, per launch of 20 back to back: kernel "
        f"{k4_ms:.4f} ms ({k4_bound / k4_ms:.1%} of bound); one call "
        f"{k4_one:.4f} ms; plain {k4_plain:.4f} ms, bound "
        f"{k4_bound:.4f} ms ({k4_by}); at the copy yardstick's rate its 6 B "
        f"per position take {6 * n4 / copy_rate * 1e3:.4f} ms [{card}]")
    log("library_ms: gear_values vs gear_t[b.long()]; null for "
        "ladder_candidates -- no PyTorch call computes the windowed sum")

    # the kernels' own path: their entry points, as a caller drives them
    counters = {"gear_values": (pk.gear_values,),
                "ladder_candidates": (pk.ladder_candidates,)}
    zero_counts(counters)
    g_path = pk.gear_values(ext)
    cl, cs = pk.ladder_candidates(g_path, n_valid, mask_s=ms, mask_l=ml)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    want_l = pk.ladder_candidates_plain(g, n_valid, mask_s=ms, mask_l=ml)[0]
    if not (torch.equal(g_path, g) and torch.equal(cl, want_l)):
        raise AssertionError("the gear/ladder entry-point path disagrees")
    log(f"K3/K4 entry-point path: launches {launches}")
    for name, c in launches.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} not launched on its path")
    return [
        {"name": "gear_values", "route": "cuda",
         "source": "backuwup_tpu_torch/csrc/gear_values.cu",
         "replaces": "backuwup_tpu/ops/pallas_kernels.py:63",
         "launches": launches["gear_values"], "max_abs_err": err3,
         "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": k3_lib},
        {"name": "ladder_candidates", "route": "cuda",
         "source": "backuwup_tpu_torch/csrc/ladder_candidates.cu",
         "replaces": "backuwup_tpu/ops/pallas_kernels.py:116",
         "launches": launches["ladder_candidates"], "max_abs_err": err4,
         "ms": k4_ms, "plain_ms": k4_plain, "bound_ms": k4_bound,
         "bound_by": k4_by, "library_ms": None},
    ]


def probe_steps(alpha: float):
    """Expected linear-probing steps at load ``alpha``: (hit, miss)."""
    return 0.5 * (1 + 1 / (1 - alpha)), 0.5 * (1 + 1 / (1 - alpha) ** 2)


def dedup_insert_bytes(n_lanes: int, n_hits: int, n_new: int,
                       alpha: float) -> float:
    """Bytes an insert batch must move, in 32-byte sectors for the random
    table accesses: each query row read, one key sector per probe step,
    one value sector per hit, a key and a value sector written per new
    key, found and lost written."""
    hit, miss = probe_steps(alpha)
    steps = n_hits * hit + (n_lanes - n_hits) * miss
    return (16 * n_lanes + SECTOR * steps + SECTOR * n_hits
            + 2 * SECTOR * n_new + 8 * n_lanes)


def phase_dedup(torch, rng, card):
    """K5 at a deployment's size against its plain version and a host
    oracle; returns the JSON row (launches filled in by the caller)."""
    import dataclasses

    from backuwup_tpu_torch.ops import dedup_index as di

    dev = torch.device("cuda")

    def clone(idx):
        return dataclasses.replace(idx, keys=idx.keys.clone(),
                                   values=idx.values.clone())

    def same(a, b) -> bool:
        return torch.equal(a.keys, b.keys) and torch.equal(a.values, b.values)

    cap, n_batches, batch = 1 << 23, 64, 65536
    rep = batch // 100
    keys_np = rng.integers(1, 2**32, (n_batches * batch, 4),
                           dtype=np.uint64).astype(np.uint32)
    keys_d = torch.from_numpy(keys_np.view(np.int32)).to(dev)
    # the host oracle: which keys the table holds, and their values
    in_table = np.zeros(n_batches * batch, dtype=bool)
    stored = np.zeros(n_batches * batch, dtype=np.int64)
    idx = di.ShardedDedupIndex.create(1, capacity=cap, device=dev)
    times, plain_ms, err5, last, exhausted = [], [], 0, None, []
    rounds = []  # rounds each insert call ran
    t_wall = time.perf_counter()
    for b in range(n_batches):
        base = b * batch
        lanes = np.concatenate([
            np.arange(base, base + batch),
            rng.integers(base, base + batch, rep),          # repeats
            rng.integers(0, base, rep) if b else
            rng.integers(base, base + batch, rep)])          # resident
        lanes = lanes[rng.permutation(len(lanes))]
        lanes_d = torch.from_numpy(lanes).to(dev)
        q = keys_d[lanes_d]
        v = torch.arange(len(lanes), dtype=torch.int32, device=dev) + (b << 17)
        alpha = base / cap
        if b == n_batches - 1:
            # time the last batch on clones (an insert mutates the table):
            # CUDA events around the call, the host's clock around the
            # call alone (its enqueue), then the kernel's device time from
            # the profiler over separate calls
            reps, host = [], []
            for _ in range(7):
                c = clone(idx)
                torch.cuda.synchronize()
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                h0 = time.perf_counter()
                c.insert_device(q, v)
                host.append((time.perf_counter() - h0) * 1e3)
                t1.record()
                t1.synchronize()
                reps.append(t0.elapsed_time(t1))
                del c
            last = (statistics.median(reps), len(lanes), alpha,
                    statistics.median(host), insert_device_ms(
                        torch, lambda: clone(idx), q, v),
                    insert_device_ms(torch, lambda: clone(idx),
                                     torch.zeros_like(q), v))
        plain = clone(idx) if b in (0, 1, n_batches - 2, n_batches - 1) \
            else None
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        found, lost = idx.insert_device(q, v)
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
        rounds.append(idx.scratch.rounds_run())
        if plain is not None:
            torch.cuda.synchronize()
            p0 = time.perf_counter()
            f_p, l_p = di.insert_table_plain(plain.keys, plain.values, q, v,
                                             max_probes=plain.max_probes)
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - p0) * 1e3)
            e = max_abs_err(torch, [found, lost, idx.keys.view(-1),
                                    idx.values.view(-1)],
                            [f_p, l_p, plain.keys.view(-1),
                             plain.values.view(-1)])
            err5 = max(err5, e)
            ok = e == 0 and same(idx, plain)
            log(f"K5 insert batch {b} (load {alpha:.4f}): found/lost/table "
                f"bit-exact vs plain={ok}")
            if not ok:
                raise AssertionError("dedup kernel disagrees with its plain "
                                     "version")
            del plain, f_p, l_p
        # host oracle: found = stored value + 1 exactly for keys the table
        # holds; a lane whose probe ran max_probes slots without a key or
        # an empty slot reports LOST_EXHAUSTED (the dedup front resolves it
        # on the host and grows the table) and its key is not inserted
        f = found.cpu().numpy().view(np.uint32).astype(np.int64)
        lost_np = lost.cpu().numpy()
        ex = lost_np == di.LOST_EXHAUSTED
        want = np.where(in_table[lanes], stored[lanes] + 1, 0)
        if (lost_np[~ex] != 0).any() or (in_table[lanes] & ex).any() \
                or not np.array_equal(f[~ex], want[~ex]):
            raise AssertionError(f"K5 batch {b} misclassified")
        exhausted.append(int(ex.sum()))
        new = np.flatnonzero(~in_table[lanes] & ~ex)
        keys_new = lanes[new][::-1]  # the highest lane of a key wins
        uk, first = np.unique(keys_new, return_index=True)
        stored[uk] = (b << 17) + new[::-1][first]
        in_table[uk] = True
    live = int((idx.keys != 0).any(dim=2).sum())
    # per-batch event times include the host's enqueue of the launches
    log(f"K5 fill: {n_batches} batches of {batch} new keys + {rep} repeats "
        f"+ {rep} resident lanes into {cap} slots, {live} live keys (load "
        f"{live / cap:.4f}) in {time.perf_counter() - t_wall:.1f} s; every "
        f"classification = host oracle; LOST_EXHAUSTED lanes "
        f"{sum(exhausted)} (first in batch "
        f"{next((i for i, e in enumerate(exhausted) if e), None)}, last "
        f"batch {exhausted[-1]}) at max_probes {idx.max_probes}; event ms "
        f"per batch median {statistics.median(times):.4f} (first "
        f"{times[0]:.4f}, last {times[-1]:.4f}) [{card}]")
    log(f"K5 fill, per insert call (one cooperative kernel launch each): "
        f"rounds run {rounds}; event ms "
        f"{[round(t, 4) for t in times]} [{card}]")
    if live != int(in_table.sum()):
        raise AssertionError("table does not hold exactly the oracle's keys")

    # probe batch: 2^20 queries, half resident
    n_probe = 1 << 20
    pick = rng.integers(0, n_batches * batch, n_probe // 2)
    fresh = rng.integers(1, 2**32, (n_probe // 2, 4),
                         dtype=np.uint64).astype(np.uint32)
    pq = torch.cat([keys_d[torch.from_numpy(pick).to(dev)],
                    torch.from_numpy(fresh.view(np.int32)).to(dev)])
    perm = torch.from_numpy(rng.permutation(n_probe)).to(dev)
    pq = pq[perm].contiguous()
    found = idx.probe_device(pq)
    want = di.probe_table_plain(idx.keys, idx.values, pq,
                                max_probes=idx.max_probes)
    host_want = np.concatenate([np.where(in_table[pick], stored[pick] + 1,
                                         0), np.zeros(n_probe // 2,
                                                      np.int64)])
    host_want = host_want[perm.cpu().numpy()]
    got = found.cpu().numpy().view(np.uint32).astype(np.int64)
    ok = torch.equal(found, want) and np.array_equal(got, host_want)
    log(f"K5 probe {n_probe} (half resident, load 0.5): bit-exact vs plain "
        f"and host oracle={ok}")
    if not ok:
        raise AssertionError("dedup probe disagrees")
    probe_k = cuda_ms(torch, lambda: idx.probe_device(pq))
    probe_host = []  # the host's enqueue of a probe call: one plain launch
    for _ in range(7):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        idx.probe_device(pq)
        probe_host.append((time.perf_counter() - h0) * 1e3)
    probe_p = cuda_ms(torch, lambda: di.probe_table_plain(
        idx.keys, idx.values, pq, max_probes=idx.max_probes), reps=3, warm=1)
    hit, miss = probe_steps(0.5)
    probe_bytes = (16 * n_probe + SECTOR * n_probe / 2 * (hit + miss)
                   + SECTOR * n_probe / 2 + 4 * n_probe)
    probe_b, _ = bound_ms(probe_bytes, 0)
    log(f"K5 probe time: kernel {probe_k:.4f} ms, plain {probe_p:.4f} ms, "
        f"bound {probe_b:.4f} ms (bytes; {hit:.2f} steps per hit, "
        f"{miss:.2f} per miss at load 0.5) [{card}]")
    del idx, pq, found, want

    # growth: 2^21 slots at load 0.5 -> 2^23, kernel vs plain migration
    small = di.ShardedDedupIndex.create(1, capacity=1 << 21, device=dev)
    placed = 0
    for s0 in range(0, 1 << 20, batch):
        _f, lost = small.insert_device(
            keys_d[s0:s0 + batch],
            torch.arange(batch, dtype=torch.int32, device=dev) + s0)
        placed += batch - int((lost == di.LOST_EXHAUSTED).sum())
    if int((small.keys != 0).any(dim=2).sum()) != placed:
        raise AssertionError("growth table lost keys")
    torch.cuda.synchronize()
    r0 = di.migrate_round.launches
    t0 = time.perf_counter()
    grown = small.grown(1 << 23)
    torch.cuda.synchronize()
    grow_s = time.perf_counter() - t0
    rounds = di.migrate_round.launches - r0
    nk = torch.zeros_like(grown.keys)
    nv = torch.zeros_like(grown.values)
    pending = (small.keys != 0).any(dim=2).reshape(-1).to(torch.uint8)
    while True:
        more, exhausted = di.migrate_round_plain(
            small.keys, small.values, nk, nv, pending,
            max_probes=small.max_probes)
        if exhausted:
            raise AssertionError("plain migration exhausted")
        if not more:
            break
    ok = torch.equal(grown.keys, nk) and torch.equal(grown.values, nv)
    log(f"K5 grown 2^21 -> 2^23 ({placed} keys, load "
        f"{placed / (1 << 21):.4f}): {rounds} migration rounds, "
        f"{grow_s * 1e3:.1f} ms host wall, table bit-exact vs plain={ok} "
        f"[{card}]")
    if not ok:
        raise AssertionError("dedup migration disagrees")
    del small, grown, nk, nv, keys_d

    k5_ms, n_lanes, alpha, k5_host, k5_dev, k5_pad = last
    n_hits = rep
    k5_bound, k5_by = bound_ms(dedup_insert_bytes(n_lanes, n_hits, batch,
                                                  alpha), 0)
    hit, miss = probe_steps(alpha)
    log(f"K5 insert time ({n_lanes} lanes, {batch} new keys, load "
        f"{alpha:.4f}): kernel {k5_ms:.4f} ms, plain {plain_ms[-1]:.4f} ms, "
        f"bound {k5_bound:.4f} ms (bytes; {hit:.2f} steps per hit, "
        f"{miss:.2f} per miss) [{card}]")
    log(f"K5 insert call decomposed: CUDA events around the call "
        f"{k5_ms:.4f} ms; the host's clock around the call alone (its "
        f"enqueue) {k5_host:.4f} ms (a probe call's, one plain launch "
        f"through the same wrapper pattern: "
        f"{statistics.median(probe_host):.4f} ms); the kernel's device time "
        + (f"{k5_dev:.4f} ms" if k5_dev is not None else "not measured "
           "(the profiler reported none)")
        + "; an all-padding batch of as many lanes (one round, no probe "
        "walk: the launch and the round's three grid barriers) "
        + (f"{k5_pad:.4f} ms" if k5_pad is not None else "not measured")
        + f" [{card}]")
    log("library_ms: null for dedup_probe -- no PyTorch call computes a "
        "hash-table probe/insert")
    return {"name": "dedup_probe", "route": "cuda",
            "source": "backuwup_tpu_torch/csrc/dedup_probe.cu",
            "replaces": "backuwup_tpu/ops/dedup_index.py:227 (XLA program "
                        "on the TPU, not a Pallas kernel)",
            "max_abs_err": err5, "ms": k5_ms, "plain_ms": plain_ms[-1],
            "bound_ms": k5_bound, "bound_by": k5_by, "library_ms": None}


def insert_device_ms(torch, fresh, q, v, reps: int = 3):
    """Device time of one insert kernel (``insert_rounds_kernel``), from
    the profiler over ``reps`` inserts of ``q``/``v`` into ``fresh()``
    tables; None when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    tables = [fresh() for _ in range(reps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for t in tables:
            t.insert_device(q, v)
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if "insert_rounds_kernel" in e.key:
            total += float(getattr(e, "self_device_time_total", 0.0)
                           or getattr(e, "self_cuda_time_total", 0.0) or 0.0)
            count += e.count
    return total / count / 1e3 if count and total > 0 else None


def log_sass(build_dir, libs) -> None:
    """SASS instructions of each kernel in ``libs``, counted with
    ``cuobjdump -sass`` where the toolkit has it (a fully unrolled kernel's
    count over the positions it handles gives instructions per position)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log("sass: cuobjdump not found")
        return
    for name in libs:
        out = subprocess.run([tool, "-sass", str(build_dir / f"lib{name}.so")],
                             capture_output=True, text=True, timeout=120)
        counts, fn = {}, None
        for line in out.stdout.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = 0
            elif fn and line.strip().startswith("/*") and ";" in line:
                counts[fn] += 1
        for fn, n in counts.items():
            log(f"sass {name}: {n} instructions in {fn}")


def zero_counts(counters) -> None:
    for fns in counters.values():
        for fn in fns:
            fn.launches = 0


def read_counts(counters):
    return {name: sum(fn.launches for fn in fns)
            for name, fns in counters.items()}


class SetAuthority:
    """The dedup front's host authority (``MeshDedupIndex`` docstring): a
    set of hashes queued for packing; counts its lookups."""

    def __init__(self):
        self.queued = set()
        self.lookups = 0

    def __len__(self) -> int:
        return 0  # nothing committed to a packfile in this run

    @property
    def queued_count(self) -> int:
        return len(self.queued)

    def known_hashes(self):
        return list(self.queued)

    def is_duplicate(self, h) -> bool:
        self.lookups += 1
        return bytes(h) in self.queued

    def mark_queued(self, h) -> None:
        self.queued.add(bytes(h))


def make_corpus(rng):
    """~2.6 GiB of seeded streams covering every route of the pipeline."""
    files = [rng.bytes(96 * MiB) for _ in range(8)]           # 1-row batches
    sizes = np.exp(rng.uniform(np.log(256 * 1024 + 1), np.log(16 * MiB), 300))
    files += [rng.bytes(int(n)) for n in sizes]               # multi-row
    files += [rng.bytes(int(n)) for n in rng.integers(1, 256 * 1024 + 1, 2000)]
    files += [files[8 + 7 * k] for k in range(20)]            # repeated files
    files += [files[308 + k] for k in range(40)]              # repeated tiny
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
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = backend.manifest_many(streams)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts(counters)
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
    return out, launches, total / MiB / secs


def _tuples(manifests):
    return [[(r.offset, r.length, r.hash) for r in refs] for refs in manifests]


def run_classified(torch, backend, streams, counters, label, card,
                   unclassified):
    """The classified main path, twice: ``manifest_many_classified`` with
    a fresh ``MeshDedupIndex`` over a set-backed authority.  Manifests
    must equal the unclassified run's (``unclassified``: its manifests
    and MiB/s); pass 1's hints must equal the host oracle (first
    occurrence new, repeats duplicates); after the authority queues every
    hash, pass 2's must all be duplicates.  Returns pass 1's launch
    counts."""
    from backuwup_tpu_torch.ops import dedup_index as di
    from backuwup_tpu_torch.snapshot.device_dedup import MeshDedupIndex

    authority = SetAuthority()
    dedup = MeshDedupIndex(authority)
    lost = []
    dedup.note_window = lambda n_real, n_lost: lost.append(n_lost)
    zero_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, hints = backend.manifest_many_classified(streams, dedup)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts(counters)
    inserts = di.insert_table.launches
    pipe = backend.pipeline
    hashes = [r.hash for refs in out for r in refs]
    seen = set()
    oracle = [h in seen or seen.add(h) is not None for h in hashes]
    total = sum(len(s) for s in streams)
    log(f"{label}, classified pass 1: {len(hashes)} chunks, "
        f"{sum(hints)} duplicates, {total / MiB / secs:.1f} MiB/s end to "
        f"end (unclassified {unclassified[1]:.1f} MiB/s); launches "
        f"{launches}; lost lanes {sum(lost)} over {len(lost)} batches; "
        f"host-resolved hashes {authority.lookups}; oracle re-runs "
        f"{pipe.oracle_reruns}, pool re-runs {pipe.pool_reruns} [{card}]")
    if hints != oracle:
        raise AssertionError("classified hints differ from the host oracle")
    if sum(hints) == 0 or len(hints) != len(hashes):
        raise AssertionError("classified pass found no duplicates")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} not launched on the "
                                 "classified path")
    if pipe.oracle_reruns or pipe.pool_reruns:
        raise AssertionError("overflow re-runs on the classified path")
    if _tuples(out) != _tuples(unclassified[0]):
        raise AssertionError("classified manifests differ from manifest_many")
    for h in hashes:
        authority.mark_queued(h)
    lookups = authority.lookups
    t0 = time.perf_counter()
    out2, hints2 = backend.manifest_many_classified(streams, dedup)
    torch.cuda.synchronize()
    secs2 = time.perf_counter() - t0
    log(f"{label}, classified pass 2 (every hash queued): all duplicates="
        f"{all(hints2)}, {total / MiB / secs2:.1f} MiB/s, host-resolved "
        f"hashes {authority.lookups - lookups} [{card}]")
    if not all(hints2) or _tuples(out2) != _tuples(out):
        raise AssertionError("classified pass 2 is wrong")
    rounds = insert_rounds(backend, streams)
    log(f"{label}, classified pass 1: {inserts} insert "
        f"calls, one cooperative kernel launch each; rounds run per call "
        f"(untimed repeat, {len(rounds)} calls) {rounds} [{card}]")
    return launches


def insert_rounds(backend, streams):
    """Rounds each insert kernel launch ran in a classified pass, from an
    untimed repeat with a fresh authority and table: the same batches
    race alike, so these are the timed pass's rounds.  Each read syncs the
    host, which is why no timed pass reads them."""
    from backuwup_tpu_torch.ops import dedup_index as di
    from backuwup_tpu_torch.snapshot.device_dedup import MeshDedupIndex

    insert_device, rounds = di.ShardedDedupIndex.insert_device, []

    def counting(self, q_dev, v_dev):
        calls = di.insert_table.launches
        out = insert_device(self, q_dev, v_dev)
        if di.insert_table.launches > calls:
            rounds.append(self.scratch.rounds_run())
        return out

    di.ShardedDedupIndex.insert_device = counting
    try:
        backend.manifest_many_classified(streams,
                                         MeshDedupIndex(SetAuthority()))
    finally:
        di.ShardedDedupIndex.insert_device = insert_device
    return rounds


def breakdown(torch, run, streams, label, card):
    """Device time by kernel over one profiled call ``run(streams)``: the
    hand-written kernels, copies, and the plain torch ops around them,
    with the device's busy share of the call's wall time; returns the
    device events per group (None when the profiler reported none)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(streams)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {"scan_candidates": 0.0, "blake3_leaf": 0.0, "dedup_probe": 0.0,
              "memcpy": 0.0, "torch ops": 0.0}
    counts = dict.fromkeys(groups, 0)
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
        elif "insert_" in name and "_kernel" in name:
            g = "dedup_probe"
        elif "memcpy" in name.lower() or "memset" in name.lower():
            g = "memcpy"
        else:
            g = "torch ops"
        groups[g] += t
        counts[g] += e.count
        top.append((t, e.count, name[:60]))
    busy = sum(groups.values())
    if busy <= 0:
        log(f"breakdown {label}: device time not measured (the profiler "
            "reported none)")
        return None
    total = sum(len(s) for s in streams)
    log(f"breakdown {label}: {total / MiB:.1f} MiB, wall {wall_us / 1e3:.1f} "
        f"ms (profiled), device busy {busy / 1e3:.1f} ms = "
        f"{100 * busy / wall_us:.1f}% of wall, idle "
        f"{100 * (1 - busy / wall_us):.1f}% [{card}]")
    for g, t in groups.items():
        log(f"  {g}: {t / 1e3:.2f} ms ({100 * t / busy:.1f}% of device time)"
            f", {counts[g]} device events")
    log(f"  torch-op kernel launches: {counts['torch ops']}")
    for t, n, name in sorted(top, reverse=True)[:8]:
        log(f"  top: {t / 1e3:8.2f} ms x{n:6d} {name}")
    return counts


def _oracle_cuts(job):
    from backuwup_tpu_torch.ops import cdc_cpu

    data, params = job
    return cdc_cpu.chunk_stream(data, params)


def _oracle_digests(pieces):
    from backuwup_tpu_torch.ops import blake3_cpu

    return blake3_cpu.blake3_many(pieces)


def oracle_manifests(streams, params, workers: int):
    """The ``cdc_cpu`` + ``blake3_cpu`` manifests of ``streams``, as
    ``(offset, length, digest)`` lists.  The oracles run numpy on one core
    each, so they run in spawned worker processes, largest stream first:
    the cuts of each stream, then the digests in pieces of ~8 MiB.  A
    worker that dies fails the run (``BrokenProcessPool``)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    order = sorted(range(len(streams)), key=lambda k: -len(streams[k]))
    jobs, owners = [], []
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        cuts = dict(zip(order, pool.map(
            _oracle_cuts, [(streams[k], params) for k in order])))
        for k in order:
            piece, size = [], 0
            for o, n in cuts[k]:
                piece.append(streams[k][o:o + n])
                size += n
                if size >= 8 * MiB:
                    jobs.append(piece)
                    owners.append(k)
                    piece, size = [], 0
            if piece:
                jobs.append(piece)
                owners.append(k)
        digests = list(pool.map(_oracle_digests, jobs))
    per_stream = {k: [] for k in range(len(streams))}
    for k, d in zip(owners, digests):
        per_stream[k].extend(d)
    return [[(o, n, h) for (o, n), h in zip(cuts[k], per_stream[k])]
            for k in range(len(streams))]


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
    from backuwup_tpu_torch.ops import blake3_gpu, dedup_index, scan_fused
    from backuwup_tpu_torch.ops.backend import GpuBackend
    from backuwup_tpu_torch.ops.gear import CDCParams
    from backuwup_tpu_torch.snapshot.device_dedup import MeshDedupIndex

    # 1. build + device
    t0 = time.perf_counter()
    reports = kernels.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s into {kernels.build_dir()}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if any(k in line for k in ("registers", "spill", "stack frame")):
                log(f"ptxas {name}: {line.strip()}")
    log_sass(kernels.build_dir(), ("scan_candidates", "dedup_probe",
                                   "gear_values", "ladder_candidates"))
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

    # the phases added after the first slice draw from their own stream,
    # so the corpus below stays the one earlier runs measured
    rng_k = np.random.default_rng([args.seed, 2])
    rows += phase_gear_ladder(torch, rng_k, card)
    torch.cuda.empty_cache()
    dedup_row = phase_dedup(torch, rng_k, card)
    torch.cuda.empty_cache()

    # 3. the main path at real size, then the classified main path
    counters = {"scan_candidates": (scan_fused.candidate_words,),
                "blake3_leaf": (blake3_gpu.leaf_scan,),
                "dedup_probe": (dedup_index.insert_table,
                                dedup_index.probe_table,
                                dedup_index.migrate_round)}
    t0 = time.perf_counter()
    corpus = make_corpus(rng)
    log(f"corpus: {len(corpus)} files, "
        f"{sum(map(len, corpus)) / MiB:.1f} MiB, made in "
        f"{time.perf_counter() - t0:.1f} s")
    backend = GpuBackend(strict_overflow=True)
    manifest_counters = {k: counters[k]
                         for k in ("scan_candidates", "blake3_leaf")}
    main_out, launches, main_mib_s = run_main(
        torch, backend, corpus, manifest_counters,
        "main path, CDCParams() 256K/1M/3M", card)
    for row in rows:
        if row["name"] in launches:
            row["launches"] = launches[row["name"]]
    part, size = [], 0
    for s in corpus[:2] + corpus[8:308]:
        if size >= 256 * MiB:
            break
        part.append(s)
        size += len(s)
    part += corpus[2308:2318]  # repeats of multi-row files in the part
    backend64 = GpuBackend(CDCParams.from_desired(64 * 1024),
                           strict_overflow=True)
    part_out, _, part_mib_s = run_main(
        torch, backend64, part, manifest_counters,
        "64 KiB chunks (from_desired(65536))", card)
    classified = run_classified(torch, backend, corpus, counters,
                                "main path, CDCParams() 256K/1M/3M", card,
                                (main_out, main_mib_s))
    dedup_row["launches"] = classified["dedup_probe"]
    rows.append(dedup_row)
    # unclassified again, after the classified passes: the first run also
    # warmed the allocator and the pinned pool
    run_main(torch, backend, corpus, manifest_counters,
             "main path again, unclassified", card)
    run_classified(torch, backend64, part, counters,
                   "64 KiB chunks (from_desired(65536))", card,
                   (part_out, part_mib_s))
    del part_out
    breakdown(torch, backend.manifest_many, corpus[:2],
              "2 one-row 96 MiB files", card)
    multi_tiny = corpus[8:48] + corpus[308:508]
    breakdown(torch, backend.manifest_many, multi_tiny,
              "40 multi-row + 200 tiny files", card)
    calls = dedup_index.insert_table.launches
    counts = breakdown(torch, lambda streams: backend.manifest_many_classified(
        streams, MeshDedupIndex(SetAuthority())), multi_tiny,
        "40 multi-row + 200 tiny files, classified", card)
    calls = dedup_index.insert_table.launches - calls
    if counts is not None:
        log(f"K5 in the profiled classified call: {calls} insert calls, "
            f"{counts['dedup_probe']} insert kernel launches on the device")
        if counts["dedup_probe"] != calls:
            raise AssertionError("an insert call is not one kernel launch")

    # 4. oracle parity on a >= 16 MiB subset covering every route, and on
    # the main path's largest shapes: a one-row 128 MiB batch (pool tiers
    # up to the 3072-leaf span) and the 304 MiB stream over 128 MiB segments
    multi = [i for i in range(8, 308)
             if 256 * 1024 < len(corpus[i]) <= 512 * 1024]
    idxs = multi + list(range(308, 348)) + [0, len(corpus) - 1]
    long_be = GpuBackend(strict_overflow=True)
    long_be.pipeline.scanner.segment_size = 8 * MiB
    long_data = rng.bytes(20 * MiB) + corpus[0][:4 * MiB]
    got = [main_out[i] for i in idxs] + long_be.manifest_many([long_data])
    streams = [corpus[i] for i in idxs] + [long_data]
    workers = min(8, os.cpu_count() or 1)
    t0 = time.perf_counter()
    want = oracle_manifests(streams, backend.params, workers)
    for i, refs, w in zip(idxs + ["long-path"], got, want):
        if [(r.offset, r.length, r.hash) for r in refs] != w:
            raise AssertionError(f"stream {i} differs from the oracle")
    checked = sum(map(len, streams))
    log(f"oracle parity: {len(multi)} batched (one 512 KiB bucket), 40 "
        f"tiny, 1 long-path stream (8 MiB segments), one 96 MiB one-row "
        f"batch and the 304 MiB long stream of the main path: "
        f"{checked / MiB:.1f} MiB bit-identical (oracles in "
        f"{time.perf_counter() - t0:.1f} s on {workers} processes)")
    if checked < 16 * MiB or len(multi) < 2:
        raise AssertionError("parity subset too small")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
