#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port's backup data plane on one card.

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
   batch through ``ShardedDedupIndex.probe``, a 2^21 -> 2^23 growth as
   one launch), every classification held against a host oracle and the
   first and last two batches, the probe and the growth against the
   plain version, whole tables bit-identical, the claim vector all -1
   after every growth; each insert call's time and the rounds its one
   kernel launch ran; the probe's and the growth's device time between
   CUDA events around launches queued behind a sleep; and the cases a
   full-size table hides (a race-heavy growth, capacities that are not
   powers of two, eight shards, probe windows that wrap); K6 the
   GF(2^8) Reed-Solomon product: RS(4, 2) encode of 64 stripes of 4 x 4
   MiB and decode of them from survivors {2, 3, 4, 5}, odd L and L = 1,
   samples against ``gf_cpu``, and the engine's one call per 3 MiB
   packfile (host time around the entry point beside the kernel's);
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
   processes;
5. the pack phase (:func:`phase_pack`), the backup data plane at a real
   user's size: a ``BlobIndex`` authority of 6,000,000 synthetic digests,
   the ``TieredDedupIndex`` on the card at the default budget (hot table
   at its 2^23-slot cap, the rest in the cold store), ``DirPacker`` over
   ``GpuBackend`` backing up a ~1.1 GiB tree, a recency shift of at least
   2,000,000 fresh fingerprints that demotes the tree's, then an
   incremental backup with ~0.4 GiB more; each root equal to the
   host-only packer's, both restores byte-identical, every manifest equal
   to the oracles, no divergence, the first tree's chunks all duplicates
   (some answered by the cold tier), the hot table under the budget; and
   a smaller history's front growing below the cap (K5's migration, one
   launch between CUDA events, held against the plain migration);
6. the stripe phase (:func:`phase_stripe`), over the first 150 of the
   ~246 packfiles the pack phase sealed in backup 1 (~520 of ~840 MiB;
   the pack phase's manifest oracles run beside it): what the engine
   does to their bytes, over the port's
   network plane -- its ``CoordinationServer`` on ``127.0.0.1`` and eight
   clients (an owner and seven holders, each its own identity, store,
   ``ServerClient`` and ``P2PNode``): holders matched through the server,
   challenge tables, ``split_packfile(.., 4, 2, GpuBackend())``, a shard
   to each of six holders over signed P2P transports, audit rounds over
   the wire answered by each holder's ``serve_audit`` on ``GpuBackend``
   (all pass, then a corrupted window detected and its holder demoted),
   two holders dark, the survivors' shards pulled over ``RESTORE_FETCH``
   and the lost ones rebuilt byte-identical and re-homed on a seventh
   holder the server matched, ``backup_done`` / ``backup_restore``, the
   survivors' shards pulled into ``RestoreFilesWriter`` and
   ``assemble_tree``; every assembled packfile equal to the sealed one,
   snapshot 1 restored from them (and local copies of the rest)
   byte-identical, every container equal to the host oracle's; K2/K6 launches, ``digest_many`` calls and their
   time, MiB/s of split, delivery, pulls, rebuild and assemble, audit
   round trips, the server's ``/healthz`` and counters.

The build phase also logs the versions of ``aiohttp``, ``websockets`` and
``cryptography``, which the network plane imports.

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
# per (output byte, input row) of the GF(2^8) product: one lookup in a
# shared product table (an LDS, 2 at the int32 rate as above) and one XOR
# into the accumulator
GF_OPS_PER_LOOKUP = 2 + 1
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


def u8_err(torch, got, want) -> int:
    """``max_abs_err`` of uint8 tensors without widening them."""
    err = 0
    for g, w in zip(got, want):
        if g.numel():
            err = max(err, int((torch.maximum(g, w)
                                - torch.minimum(g, w)).max()))
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


def phase_gf(torch, rng, card):
    """K6, the GF(2^8) Reed-Solomon product, against its plain version on
    the card at the stripe path's widths: RS(4, 2) encode of 64 stripes of
    4 x 4 MiB (16 MiB packfiles) and decode of the same batch from
    survivors {2, 3, 4, 5}; the engine's one call per 3 MiB packfile; odd
    L and L = 1; samples held against ``gf_cpu``.  Returns the JSON row
    (launches filled in by the stripe phase)."""
    from backuwup_tpu_torch import defaults
    from backuwup_tpu_torch.erasure import gf_cpu, rs_gpu

    dev = torch.device("cuda")
    k, m = defaults.RS_K, defaults.RS_M
    b_n, ln = 64, defaults.PACKFILE_MAX_SIZE // k
    x = torch.from_numpy(rng.integers(0, 256, (b_n, k, ln),
                                      dtype=np.uint8)).to(dev)
    enc = torch.from_numpy(gf_cpu.generator_matrix(k, m)[k:].copy()).to(dev)
    present = [2, 3, 4, 5]
    dec = torch.from_numpy(
        gf_cpu.decode_matrix(k, m, present)[:, present].copy()).to(dev)
    parity = rs_gpu.gf_matmul(enc, x)
    surv = torch.cat([x[:, 2:], parity], dim=1)
    data = rs_gpu.gf_matmul(dec, surv)
    err = u8_err(torch, [parity, data],
                 [rs_gpu.gf_matmul_plain(enc, x),
                  rs_gpu.gf_matmul_plain(dec, surv)])
    torch.cuda.synchronize()
    rebuilt = torch.equal(data, x)
    host_x = x[[0, b_n - 1]].cpu().numpy()
    host_p = parity[[0, b_n - 1]].cpu().numpy()
    oracle = all(np.array_equal(gf_cpu.encode_stripe(s, m), p)
                 for s, p in zip(host_x, host_p))
    log(f"K6 gf_matmul encode {b_n} x {k} x {ln} and decode from survivors "
        f"{present}: bit-exact vs plain={err == 0}, decode gives the data "
        f"back={rebuilt}, gf_cpu on stripes 0 and {b_n - 1}={oracle}")
    if err or not rebuilt or not oracle:
        raise AssertionError("gf_matmul kernel disagrees")
    # odd L, L = 1 and the engine's shape through the numpy entry points
    for shape in ((1, k, 786_433), (b_n, k, 1), (3, k, 4097)):
        s_np = rng.integers(0, 256, shape, dtype=np.uint8)
        p_np = rs_gpu.encode_stripes(s_np, m)
        want = np.stack([gf_cpu.encode_stripe(s, m) for s in s_np])
        full = np.concatenate([s_np, p_np], axis=1)
        back = rs_gpu.decode_stripes(full[:, present], k, m, present)
        s_d = torch.from_numpy(s_np).to(dev)
        e = u8_err(torch, [rs_gpu.gf_matmul(enc, s_d)],
                   [rs_gpu.gf_matmul_plain(enc, s_d)])
        torch.cuda.synchronize()
        ok = np.array_equal(p_np, want) and np.array_equal(back, s_np)
        log(f"K6 gf_matmul B, k, L = {shape}: bit-exact vs plain={e == 0}, "
            f"gf_cpu encode and decode={ok}")
        if e or not ok:
            raise AssertionError(f"gf_matmul kernel disagrees at {shape}")
        err = max(err, e)

    enc_ms = cuda_ms(torch, lambda: rs_gpu.gf_matmul(enc, x))
    dec_ms = cuda_ms(torch, lambda: rs_gpu.gf_matmul(dec, surv))
    enc_plain = cuda_ms(torch, lambda: rs_gpu.gf_matmul_plain(enc, x),
                        reps=5, warm=1)
    dec_plain = cuda_ms(torch, lambda: rs_gpu.gf_matmul_plain(dec, surv),
                        reps=5, warm=1)
    n_in = x.numel()
    enc_bound, enc_by = bound_ms(n_in + b_n * m * ln,
                                 b_n * m * k * ln * GF_OPS_PER_LOOKUP)
    dec_bound, dec_by = bound_ms(2 * n_in, b_n * k * k * ln * GF_OPS_PER_LOOKUP)
    log(f"K6 time, encode {n_in / MiB:.0f} MiB -> {b_n * m * ln / MiB:.0f} "
        f"MiB: kernel {enc_ms:.4f} ms ({enc_bound / enc_ms:.1%} of bound), "
        f"plain {enc_plain:.4f} ms, bound {enc_bound:.4f} ms ({enc_by}); "
        f"decode {n_in / MiB:.0f} MiB -> {n_in / MiB:.0f} MiB: kernel "
        f"{dec_ms:.4f} ms ({dec_bound / dec_ms:.1%} of bound), plain "
        f"{dec_plain:.4f} ms, bound {dec_bound:.4f} ms ({dec_by}) [{card}]")
    del parity, surv, data
    # the engine's shape: one call per 3 MiB packfile, B = 1; the numpy
    # entry point's host time (pinned staging, upload, launch, download)
    # beside the kernel's own time
    one = rng.integers(0, 256, (1, k, defaults.PACKFILE_TARGET_SIZE // k),
                       dtype=np.uint8)
    one_d = torch.from_numpy(one).to(dev)
    one_ms = cuda_ms(torch, lambda: rs_gpu.gf_matmul(enc, one_d))
    for _ in range(2):
        rs_gpu.encode_stripes(one, m)
    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        rs_gpu.encode_stripes(one, m)
        walls.append((time.perf_counter() - t0) * 1e3)
    one_bound, _ = bound_ms(one.size * (k + m) // k, 0)
    log(f"K6 per-packfile call (B=1, L={one.shape[2]}): host time around "
        f"rs_gpu.encode_stripes {statistics.median(walls):.4f} ms (median "
        f"of 7, spread {min(walls):.4f}-{max(walls):.4f}), of which the "
        f"kernel {one_ms:.4f} ms (bound {one_bound:.4f} ms) [{card}]")
    log("library_ms: null for gf_matmul -- no PyTorch call computes a "
        "GF(2^8) product")
    return {"name": "gf_matmul", "route": "cuda",
            "source": "backuwup_tpu_torch/csrc/gf_matmul.cu",
            "replaces": "backuwup_tpu/erasure/rs_tpu.py:28 (XLA program on "
                        "the TPU, not a Pallas kernel)",
            "max_abs_err": err, "ms": enc_ms, "plain_ms": enc_plain,
            "bound_ms": enc_bound, "bound_by": enc_by, "library_ms": None}


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
    oracle; returns the insert's JSON row (launches filled in by the
    caller) and the probe's."""
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

    # probe batch: 2^20 queries, half resident, through the probe's entry
    # point (host queries in, found out): its path, whose launches it counts
    n_probe = 1 << 20
    pick = rng.integers(0, n_batches * batch, n_probe // 2)
    fresh = rng.integers(1, 2**32, (n_probe // 2, 4),
                         dtype=np.uint64).astype(np.uint32)
    perm_np = rng.permutation(n_probe)
    pq_np = np.concatenate([keys_np[pick], fresh])[perm_np]
    di.probe_table.launches = 0
    got = idx.probe(pq_np).astype(np.int64)
    probe_launches = di.probe_table.launches
    pq = torch.from_numpy(pq_np.view(np.int32)).to(dev)
    found = idx.probe_device(pq)
    want = di.probe_table_plain(idx.keys, idx.values, pq,
                                max_probes=idx.max_probes)
    host_want = np.concatenate([np.where(in_table[pick], stored[pick] + 1,
                                         0), np.zeros(n_probe // 2,
                                                      np.int64)])[perm_np]
    err_probe = max_abs_err(torch, [found], [want])
    ok = err_probe == 0 and np.array_equal(got, host_want)
    log(f"K5 probe {n_probe} (half resident, load 0.5) through "
        f"ShardedDedupIndex.probe: {probe_launches} launch; bit-exact vs "
        f"plain and host oracle={ok}")
    if not ok or probe_launches != 1:
        raise AssertionError("dedup probe disagrees")
    probe_k = queued_ms(torch, lambda: idx.probe_device(pq))
    probe_one = cuda_ms(torch, lambda: idx.probe_device(pq))
    probe_dev = kernel_device_ms(
        torch, [lambda: idx.probe_device(pq)] * 3, "probe_kernel")
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
    probe_b, probe_by = bound_ms(probe_bytes, 0)
    log(f"K5 probe time: kernel {probe_k:.4f} ms per call of 20 queued "
        f"back to back ({probe_b / probe_k:.1%} of bound; target <= "
        f"{2 * probe_b:.4f} ms, half the bound: "
        f"{'reached' if probe_k <= 2 * probe_b else 'missed'}); CUDA events "
        f"around one call {probe_one:.4f} ms; profiler device time "
        + (f"{probe_dev:.4f} ms" if probe_dev is not None else "not measured")
        + f"; host enqueue median {statistics.median(probe_host):.4f} ms; "
        f"plain {probe_p:.4f} ms, bound {probe_b:.4f} ms (bytes; {hit:.2f} "
        f"steps per hit, {miss:.2f} per miss at load 0.5) [{card}]")
    probe_row = {
        "name": "dedup_probe_table", "route": "cuda",
        "source": "backuwup_tpu_torch/csrc/dedup_probe.cu",
        "replaces": "backuwup_tpu/ops/dedup_index.py:233 (local_probe of an "
                    "XLA program on the TPU, not a Pallas kernel)",
        "launches": probe_launches, "max_abs_err": err_probe, "ms": probe_k,
        "plain_ms": probe_p, "bound_ms": probe_b, "bound_by": probe_by,
        "library_ms": None}
    log("library_ms: null for dedup_probe_table -- no PyTorch call computes "
        "a hash-table probe")
    del idx, pq, found, want
    dedup_small_cases(torch, rng, card)

    # growth: 2^21 slots at load 0.5 -> 2^23, one migration launch
    small = di.ShardedDedupIndex.create(1, capacity=1 << 21, device=dev)
    placed = 0
    for s0 in range(0, 1 << 20, batch):
        _f, lost = small.insert_device(
            keys_d[s0:s0 + batch],
            torch.arange(batch, dtype=torch.int32, device=dev) + s0)
        placed += batch - int((lost == di.LOST_EXHAUSTED).sum())
    if int((small.keys != 0).any(dim=2).sum()) != placed:
        raise AssertionError("growth table lost keys")
    grow_ms, rounds, grow_plain = migrate_vs_plain(torch, small, 1 << 23)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grown = small.grown(1 << 23)
    torch.cuda.synchronize()
    grow_s = time.perf_counter() - t0
    log(f"K5 grown 2^21 -> 2^23 ({placed} keys, load "
        f"{placed / (1 << 21):.4f}): one migration launch of {rounds} "
        f"rounds, {grow_ms:.4f} ms between CUDA events (median of 5), "
        f"plain {grow_plain:.1f} ms; "
        f"grown() {grow_s * 1e3:.1f} ms host wall (the new table's zero "
        f"fill and one host read included); table bit-exact vs plain, "
        f"claim vector all -1 [{card}]")
    del small, grown, keys_d

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
        "hash-table insert")
    return {"name": "dedup_probe", "route": "cuda",
            "source": "backuwup_tpu_torch/csrc/dedup_probe.cu",
            "replaces": "backuwup_tpu/ops/dedup_index.py:227 (XLA program "
                        "on the TPU, not a Pallas kernel)",
            "max_abs_err": err5, "ms": k5_ms, "plain_ms": plain_ms[-1],
            "bound_ms": k5_bound, "bound_by": k5_by,
            "library_ms": None}, probe_row


def insert_device_ms(torch, fresh, q, v, reps: int = 3):
    """Device time of one insert kernel (``insert_rounds_kernel``), from
    the profiler over ``reps`` inserts of ``q``/``v`` into ``fresh()``
    tables; None when the profiler reports no device time."""
    tables = [fresh() for _ in range(reps)]
    return kernel_device_ms(torch, [lambda t=t: t.insert_device(q, v)
                                    for t in tables], "insert_rounds_kernel")


def kernel_device_ms(torch, calls, kernel: str):
    """Mean device time in ms of the kernels named ``kernel`` that the
    ``calls`` launch, from the profiler; None when it reports none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if kernel in e.key:
            total += float(getattr(e, "self_device_time_total", 0.0)
                           or getattr(e, "self_cuda_time_total", 0.0) or 0.0)
            count += e.count
    return total / count / 1e3 if count and total > 0 else None


SLEEP_CYCLES = 20_000_000  # ~10 ms of torch.cuda._sleep at the SM clock


def queued_ms(torch, fn, reps: int = 7, count: int = 20, prep=None) -> float:
    """Median device time of ``fn`` in ms per call: CUDA events around
    ``count`` calls that the host enqueued while the device slept
    (``torch.cuda._sleep``), so a wrapper's host time drops out even when
    its kernel is shorter than its enqueue.  ``prep`` runs before each
    repetition, outside the events (e.g. to empty a table).  Raises if
    the host took longer to enqueue than the device slept."""
    fn()
    times = []
    for _ in range(reps):
        if prep is not None:
            prep()
        torch.cuda.synchronize()
        slept = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        slept.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(count):
            fn()
        end.record()
        host_ms = (time.perf_counter() - h0) * 1e3
        end.synchronize()
        if host_ms >= slept.elapsed_time(start):
            raise AssertionError("the enqueue outlasted the device's sleep")
        times.append(start.elapsed_time(end) / count)
    return statistics.median(times)


def migrate_vs_plain(torch, idx, new_cap: int, reps: int = 5):
    """K5's migration of ``idx`` into an empty table of ``new_cap`` slots
    per shard, each call one launch (checked by the count), and the plain
    migration of the same table: the new tables and (rounds, exhausted)
    equal, the claim vector all -1 after every launch.  Returns (median
    ms of one launch between CUDA events, rounds, plain ms)."""
    from backuwup_tpu_torch.ops import dedup_index as di

    nk, nv, claim = di._empty_table(idx.n_shards, new_cap, idx.device)
    results = []

    def launch():
        results.append(di.migrate_round(idx.keys, idx.values, nk, nv,
                                        max_probes=idx.max_probes,
                                        claim=claim))

    def empty():
        nk.zero_()
        nv.zero_()

    before = di.migrate_round.launches
    ms = queued_ms(torch, launch, reps=reps, count=1, prep=empty)
    got = [r.tolist() for r in results]
    pk, pv = torch.zeros_like(nk), torch.zeros_like(nv)
    torch.cuda.synchronize()
    p0 = time.perf_counter()
    want = di.migrate_plain(idx.keys, idx.values, pk, pv,
                            max_probes=idx.max_probes).tolist()
    plain_ms = (time.perf_counter() - p0) * 1e3
    if di.migrate_round.launches - before != len(got) \
            or any(g != want for g in got) \
            or not (torch.equal(nk, pk) and torch.equal(nv, pv)) \
            or not bool((claim == -1).all()):
        raise AssertionError("dedup migration disagrees with its plain "
                             "version")
    return ms, want[0], plain_ms


def dedup_small_cases(torch, rng, card):
    """K5's growth and probe in the cases a table at full size hides, each
    kernel bit-exact against its plain version: a race-heavy growth (64
    keys of one shard share their first slot in both tables, so each round
    places one), growths to and from capacities that are not powers of
    two, eight shards, and probes whose windows wrap at the end of the
    shard (runs of keys from its last slots, shards smaller than a probe
    group), with padding rows and stored values of 0xFFFFFFFF."""
    import dataclasses

    from backuwup_tpu_torch.ops import dedup_index as di

    dev = torch.device("cuda")

    def filled(d, cap, load, run_len, run_mod, run_start):
        n = int(load * d * cap)
        q = rng.integers(1, 2**32, (n + run_len, 4),
                         dtype=np.uint64).astype(np.uint32)
        # the other keys spread over the shards in turn, so none fills up
        q[:, 0] = q[:, 0] // d * d + np.arange(len(q)) % d
        run = q[:run_len]  # one shard's keys on one first slot
        run[:, 0] = run[:, 0] // d * d + 3 % d
        run[:, 1] = run[:, 1] // run_mod * run_mod + run_start
        v = rng.integers(0, 2**32, len(q), dtype=np.uint64).astype(np.uint32)
        v[::3] = 0xFFFFFFFF
        idx = di.ShardedDedupIndex.create(d, capacity=cap, max_probes=128,
                                          device=dev)
        idx.insert(q, v)
        return idx, q

    for label, d, cap, new_cap, racing in (
            ("race-heavy", 1, 1 << 20, 1 << 22, 64),
            ("non-power-of-two", 1, 1_000_000, 2_500_000, 0),
            ("D = 8", 8, 1 << 17, 1 << 19, 0),
            ("D = 8, non-power-of-two, race-heavy", 8, 3000, 7001, 16)):
        idx, _q = filled(d, cap, 0.45, racing, int(np.lcm(cap, new_cap)),
                         200)
        ms, rounds, plain_ms = migrate_vs_plain(torch, idx, new_cap, reps=3)
        log(f"K5 growth, {label}: {d} x {cap} -> {d} x {new_cap} slots, one "
            f"launch of {rounds} rounds, {ms:.4f} ms (plain {plain_ms:.1f} "
            f"ms); bit-exact vs plain, claim vector all -1 [{card}]")
        if rounds < racing:
            raise AssertionError("the race-heavy growth ran too few rounds")
        del idx

    for d, cap in ((8, 1000), (1, 5), (8, 3)):
        idx, q = filled(d, cap, 0.4, min(12, cap // 2), cap, cap - 1)
        unseen = rng.integers(1, 2**32, (64, 4),
                              dtype=np.uint64).astype(np.uint32)
        unseen[:8, 0] = unseen[:8, 0] // d * d + 3 % d
        unseen[:8, 1] = unseen[:8, 1] // cap * cap + cap - 1
        probe = np.vstack([q, np.zeros((5, 4), dtype=np.uint32), unseen])
        probe_d = torch.from_numpy(probe.view(np.int32)).to(dev)
        for max_probes in (5, 33):
            view = dataclasses.replace(idx, max_probes=max_probes)
            calls = di.probe_table.launches
            got = view.probe_device(probe_d)
            want = di.probe_table_plain(idx.keys, idx.values, probe_d,
                                        max_probes=max_probes)
            if di.probe_table.launches != calls + 1 \
                    or not torch.equal(got, want):
                raise AssertionError(f"dedup probe disagrees ({d} x {cap} "
                                     f"slots, max_probes {max_probes})")
        log(f"K5 probe, windows that wrap: {d} x {cap} slots, {len(probe)} "
            f"queries (a run of keys from the last slot, padding rows, "
            f"values 0xFFFFFFFF) at max_probes 5 and 33: bit-exact vs plain "
            f"[{card}]")
        del idx


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


def log_network_packages() -> None:
    """One line: whether the packages a networked engine needs import
    here, with their versions.  Fails on nothing."""
    import importlib

    found = []
    for name in ("aiohttp", "websockets", "cryptography"):
        try:
            mod = importlib.import_module(name)
            found.append(f"{name} {getattr(mod, '__version__', '?')}")
        except Exception as e:  # a probe: any failure is the answer
            found.append(f"{name} missing ({type(e).__name__})")
    log("network packages: " + ", ".join(found))


def log_host(torch) -> None:
    """One line: the host's cores as this process sees them (the stripe
    phase's one event loop shares them with oracle workers)."""
    try:
        quota = Path("/sys/fs/cgroup/cpu.max").read_text().strip()
    except OSError:
        quota = "unknown"
    log(f"host: os.cpu_count() {os.cpu_count()}, affinity "
        f"{len(os.sched_getaffinity(0))} cores, cgroup cpu.max {quota}, "
        f"torch intra-op threads {torch.get_num_threads()}")


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



# --- 5. the pack phase: a directory to sealed packfiles and back -------------

# A real user's size: an authority of 6,000,000 blobs (an earlier history of
# ~6 TB at the default 1 MiB chunk), the tiered front at the default budget
# (its hot table starts at the 2^23-slot cap), and two backups of a tree on
# local disk, ~1.5 GiB in all.  Between them ``shift`` fresh fingerprints
# (at least; see ``recency_shift``) push the first tree's out of the
# recency window.  A smaller history (2^19 blobs) shows the front growing
# below the cap, which is where K5's migration runs.  The tree: 96 MiB
# files (one-row batches), files log-uniform over 256 KiB-16 MiB
# (multi-row batches), files of 1 B-256 KiB (the tiny path), exact repeats
# of earlier files, and one file of repeated 8 MiB blocks larger than the
# packer's 256 MiB ``batch_bytes`` (the ``manifest_stream`` path).
PACK_SPEC = {
    "authority": 6_000_000,
    "shift": 2_000_000,
    "shift_block": 1 << 16,
    "growth_authority": 1 << 19,
    "growth_capacity": None,  # derived from the authority, as a user's
    "budget": None,  # DEDUP_HBM_BUDGET_BYTES
    "batch_bytes": None,  # DirPacker's default, 256 MiB
    "big": 96 * MiB,
    "multi": (256 * 1024, 16 * MiB),
    "tiny": 256 * 1024,
    "stream_block": 8 * MiB,
    "stream_blocks": 33,
    "A": {"big": 3, "multi": 100, "tiny": 1000, "repeats": 10, "stream": 1},
    "B": {"big": 1, "multi": 60, "tiny": 600, "repeats": 5, "stream": 0},
}

# the packfiles of backup 1 the stripe phase ships, audits, rebuilds and
# restores over the network, of ~246; snapshot 1 restores the rest from
# their local copies.  The transport moves ~9-10 MiB/s a leg (every shard
# over TRANSFER_CHUNK_BYTES costs a host BLAKE3 on each side), and all of
# them would take the script past 1,000 s (PERF.md §4)
STRIPE_PACKFILES = 150


def write_tree(rng, root: Path, counts, spec) -> int:
    """Seeded files under ``root``; returns their bytes."""
    total = 0

    def put(rel, data):
        nonlocal total
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
        total += len(data)

    for k in range(counts["big"]):
        put(f"big/b{k}.bin", rng.bytes(spec["big"]))
    lo, hi = spec["multi"]
    multi = []
    for k, n in enumerate(np.exp(rng.uniform(np.log(lo + 1), np.log(hi),
                                             counts["multi"]))):
        multi.append(rng.bytes(int(n)))
        put(f"multi/m{k // 25:02d}/f{k:03d}.bin", multi[-1])
    for k, n in enumerate(rng.integers(1, spec["tiny"] + 1, counts["tiny"])):
        put(f"tiny/t{k // 100:02d}/f{k:04d}.bin", rng.bytes(int(n)))
    for k in range(counts["repeats"]):
        put(f"rep/r{k:02d}.bin", multi[(7 * k) % len(multi)])
    if counts["stream"]:
        put("stream/long.bin",
            rng.bytes(spec["stream_block"]) * spec["stream_blocks"])
    return total


def synthetic_authority(rng, index, n: int, per_pack: int = 3) -> None:
    """``n`` seeded 32-byte digests committed to ``index`` under synthetic
    packfile ids, ``per_pack`` blobs each (3 MiB packfiles of 1 MiB
    chunks)."""
    raw = rng.bytes(32 * n)
    pids = rng.bytes(12 * -(-n // per_pack))
    for k in range(0, n, per_pack):
        j = 12 * (k // per_pack)
        index.finalize_packfile(pids[j:j + 12], [
            raw[32 * i:32 * i + 32] for i in range(k, min(n, k + per_pack))])


def fresh_hashes(rng, n: int):
    raw = rng.bytes(32 * n)
    return [raw[32 * i:32 * i + 32] for i in range(n)]


def metric(name, **labels) -> float:
    from backuwup_tpu_torch.obs import metrics as obs_metrics

    m = obs_metrics.registry().get(name)
    return 0.0 if m is None else m.value(**labels)


def run_backup(sync, src: Path, repo: Path, keys, index, front, backend,
               batch_bytes):
    """One backup as the engine runs it: a fresh writer sealing on
    ``PACK_SEAL_WORKERS`` threads, its packfiles committed to ``index``;
    returns (root, stats, writer, blob hashes written, seconds)."""
    from backuwup_tpu_torch import defaults
    from backuwup_tpu_torch.snapshot.packer import DirPacker
    from backuwup_tpu_torch.snapshot.packfile import PackfileWriter

    writer = PackfileWriter(
        keys, repo / "pack",
        on_packfile=lambda pid, path, hashes, size:
        index.finalize_packfile(pid, hashes),
        seal_workers=defaults.PACK_SEAL_WORKERS)
    added = []
    add = writer.add_blob

    def recording(blob):
        added.append(bytes(blob.hash))
        add(blob)

    writer.add_blob = recording
    kw = {"batch_bytes": batch_bytes} if batch_bytes else {}
    packer = DirPacker(backend, writer, index, dedup_index=front, **kw)
    sync()
    t0 = time.perf_counter()
    try:
        root = packer.pack(src)
    finally:
        writer.shutdown()
    sync()
    return root, packer.stats, writer, added, time.perf_counter() - t0


def resolver(keys, index, pack_dir: Path):
    from backuwup_tpu_torch.snapshot.packfile import PackfileReader

    reader = PackfileReader(keys, pack_dir)

    def resolve(h):
        pid = index.lookup(h)
        if pid is None:
            raise KeyError(bytes(h).hex())
        return reader.get_blob(pid, h)

    return resolve


def file_manifests(resolve, snapshot: bytes):
    """{path: [chunk hash, ...]} of every file of a snapshot, and
    {path: tree hash} of every directory."""
    from backuwup_tpu_torch.snapshot.unpacker import fetch_full_tree
    from backuwup_tpu_torch.wire import TreeKind

    files, dirs = {}, {"": snapshot}
    queue = [(fetch_full_tree(resolve, snapshot), "")]
    while queue:
        tree, path = queue.pop()
        for h in tree.children:
            child = fetch_full_tree(resolve, h)
            rel = f"{path}/{child.name}" if path else child.name
            if child.kind == TreeKind.DIR:
                dirs[rel] = bytes(h)
                queue.append((child, rel))
            else:
                files[rel] = [bytes(c) for c in child.children]
    return files, dirs


def same_tree(a: Path, b: Path) -> int:
    """Raise unless the two trees hold the same paths and bytes; returns
    the bytes compared."""
    pa = sorted(str(p.relative_to(a)) for p in a.rglob("*"))
    pb = sorted(str(p.relative_to(b)) for p in b.rglob("*"))
    if pa != pb:
        raise AssertionError(f"restored tree differs in its paths: {a} {b}")
    n = 0
    for rel in pa:
        if (a / rel).is_file():
            da = (a / rel).read_bytes()
            if da != (b / rel).read_bytes():
                raise AssertionError(f"restored file differs: {rel}")
            n += len(da)
    return n


def grow_front(torch, rng, tmp: Path, spec, device, card, counters):
    """A smaller history's front grows below the budget cap: the
    authority holds ``growth_authority`` digests, the front starts at the
    capacity they ask for, and fresh fingerprints through
    ``classify_insert`` fill it until ``_grow`` migrates it 4x on the
    device (K5's migration, one launch between CUDA events).  The grown
    table is held against the plain migration of the same old table.
    Returns the ``dedup_migrate`` JSON row."""
    from backuwup_tpu_torch.crypto import KeyManager
    from backuwup_tpu_torch.dedupstore import TieredDedupIndex
    from backuwup_tpu_torch.ops import dedup_index as di
    from backuwup_tpu_torch.snapshot.blob_index import BlobIndex

    cuda = device.type == "cuda"
    index = BlobIndex(KeyManager.from_secret(rng.bytes(32)), tmp / "index")
    synthetic_authority(rng, index, spec["growth_authority"])
    front = TieredDedupIndex(index, capacity=spec["growth_capacity"],
                             device=device, cold_dir=tmp / "cold",
                             hbm_budget_bytes=spec["budget"])
    cap0 = front.capacity
    launch_ms, results, record = [], [], {}
    grown, migrate = di.ShardedDedupIndex.grown, di.migrate_round

    def timed_migrate(*args, **kw):
        # the growth's one launch between CUDA events, queued behind a
        # sleep so that the wrapper's host time drops out (on the CPU the
        # host's clock around the plain migration); raises, as queued_ms
        # does, if the host took longer to enqueue than the device slept
        if not cuda:
            t0 = time.perf_counter()
            results.append(migrate(*args, **kw))
            launch_ms.append((time.perf_counter() - t0) * 1e3)
            return results[-1]
        torch.cuda.synchronize()
        slept = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        slept.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        results.append(migrate(*args, **kw))
        end.record()
        host_ms = (time.perf_counter() - h0) * 1e3
        end.synchronize()
        if host_ms >= slept.elapsed_time(start):
            raise AssertionError("the enqueue outlasted the device's sleep")
        launch_ms.append(start.elapsed_time(end))
        return results[-1]

    def checked_grown(self, new_capacity):
        old_k, old_v = self.keys.clone(), self.values.clone()
        # the wrapper stands in for the module's migrate_round, whose
        # launch count (``migrate_round.launches += 1``) it then carries
        timed_migrate.launches = migrate.launches
        di.migrate_round = timed_migrate
        try:
            out = grown(self, new_capacity)
        finally:
            di.migrate_round = migrate
            migrate.launches = timed_migrate.launches
        nk, nv = torch.zeros_like(out.keys), torch.zeros_like(out.values)
        if cuda:
            torch.cuda.synchronize()
        p0 = time.perf_counter()
        want = di.migrate_plain(old_k, old_v, nk, nv,
                                max_probes=self.max_probes).tolist()
        if cuda:
            torch.cuda.synchronize()
        if want != results[-1].tolist() or want[1]:
            raise AssertionError("the plain migration differs or exhausted")
        claim_ok = out.claim is None or bool((out.claim == -1).all())
        record.update(plain_ms=(time.perf_counter() - p0) * 1e3,
                      err=max_abs_err(torch, [out.keys.view(-1),
                                              out.values.view(-1)],
                                      [nk.view(-1), nv.view(-1)]),
                      placed=int((old_k != 0).any(dim=2).sum()),
                      old_cap=self.capacity, new_cap=new_capacity,
                      rounds=want[0], claim_ok=claim_ok)
        return out

    zero_counts(counters)
    di.ShardedDedupIndex.grown = checked_grown
    fed, step = 0, min(8192, max(1, cap0 // 8))
    try:
        while front.capacity == cap0:
            if fed >= 4 * cap0:
                raise AssertionError("the front never grew")
            hs = fresh_hashes(rng, step)
            if any(front.classify_insert(hs)):
                raise AssertionError("a fresh fingerprint read as duplicate")
            for h in hs:
                index.mark_queued(h)
            fed += len(hs)
    finally:
        di.ShardedDedupIndex.grown = grown
    launches, inserts = di.migrate_round.launches, di.insert_table.launches
    if len(launch_ms) != 1 or (cuda and launches != 1) or record["err"] \
            or not record["claim_ok"]:
        raise AssertionError("the growth did not run K5's migration as one "
                             "launch bit-exact against the plain version")
    placed, old_cap = record["placed"], record["old_cap"]
    alpha = placed / record["new_cap"]
    _hit, miss = probe_steps(alpha)
    bound, by = bound_ms(20 * old_cap + SECTOR * placed * (1 + miss), 0)
    ms = launch_ms[0]
    log(f"pack: growth below the cap: a front over {spec['growth_authority']}"
        f" digests starts at {cap0} slots ({front.hbm_budget_bytes} B "
        f"budget); after {fed} fresh fingerprints _grow migrated "
        f"{placed} keys {old_cap} -> {record['new_cap']} slots in {launches}"
        f" K5 migration launch of {record['rounds']} rounds ({inserts} K5 "
        f"insert launches in all): {ms:.4f} ms between CUDA events "
        f"({bound / ms:.1%} of bound; target 0.05-0.15 ms: "
        f"{'reached' if ms <= 0.15 else 'missed'}), plain "
        f"{record['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by}: old table"
        f" read, a 32 B sector per key placed and {miss:.3f} probe steps per"
        f" key at the new load {alpha:.4f}); bit-exact vs plain, claim vector"
        f" all -1 [{card}]")
    return {"name": "dedup_migrate", "route": "cuda",
            "source": "backuwup_tpu_torch/csrc/dedup_probe.cu",
            "replaces": "backuwup_tpu/ops/dedup_index.py:354 (XLA program "
                        "on the TPU, not a Pallas kernel)",
            "launches": launches, "max_abs_err": record["err"], "ms": ms,
            "plain_ms": record["plain_ms"], "bound_ms": bound,
            "bound_by": by, "library_ms": None}


def recency_shift(rng, front, index, a_chunks, spec, card):
    """Fresh fingerprints through ``classify_insert``, each marked in the
    authority, in blocks, until at least ``spec['shift']`` went through
    and the first tree's chunks have left the hot table (demoted): a
    demotion keeps the newest quarter of the table, so the shift must
    outnumber it after the first tree's last touch."""
    a_keys = {h[:16] for h in a_chunks}
    fresh, checked, t0 = 0, -1.0, time.perf_counter()
    hot_a = len(a_keys)
    while True:
        hs = fresh_hashes(rng, spec["shift_block"])
        for s in range(0, len(hs), 8192):
            batch = hs[s:s + 8192]
            if any(front.classify_insert(batch)):
                raise AssertionError("a fresh fingerprint read as duplicate")
            for h in batch:
                index.mark_queued(h)
        fresh += len(hs)
        demoted = metric("bkw_tier_demotions_total")
        if fresh >= spec["shift"] and demoted != checked:
            checked = demoted
            keys, _vals = front.sharded.dump()
            le = np.ascontiguousarray(keys.astype("<u4")).tobytes()
            hot = {le[16 * i:16 * i + 16] for i in range(len(keys))}
            hot_a = len(a_keys & hot)
            if hot_a < len(a_keys):
                break
        if fresh >= 6 * spec["shift"]:
            raise AssertionError("the first tree never left the hot table")
    log(f"pack: recency shift: {fresh} fresh fingerprints through "
        f"classify_insert in {time.perf_counter() - t0:.1f} s; demotions so "
        f"far {int(metric('bkw_tier_demotions_total'))} keys; of the first "
        f"tree's {len(a_keys)} chunk keys {hot_a} still hot; hot table "
        f"{front.hbm_table_bytes} B, cold store {len(front.cold)} records in "
        f"{front.cold.run_count} runs [{card}]")
    return fresh


def packfile_ids(pack_dir: Path):
    """Ids of the packfiles under ``pack_dir`` (``packfile_path`` layout)."""
    out = set()
    for p in Path(pack_dir).glob("*/*"):
        try:
            pid = bytes.fromhex(p.name)
        except ValueError:
            continue
        if len(pid) == 12 and p.parent.name == p.name[:2] and p.is_file():
            out.add(pid)
    return out


def phase_pack(torch, rng, card, counters, spec=PACK_SPEC, device=None,
               after=None):

    """The backup data plane at a real user's size: directory -> chunks ->
    fingerprints -> tiered dedup -> sealed packfiles + snapshot root ->
    restore, through the port's entry points; returns the migration row.
    ``after(ctx)``, if given, runs on the sealed packfiles before they are
    deleted: ``ctx`` holds the keys, the authority, the pack directory,
    and backup 1's packfile ids, snapshot root and source tree."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from backuwup_tpu_torch import defaults
    from backuwup_tpu_torch.crypto import KeyManager
    from backuwup_tpu_torch.dedupstore import TieredDedupIndex
    from backuwup_tpu_torch.ops import dedup_index as di
    from backuwup_tpu_torch.ops.backend import GpuBackend
    from backuwup_tpu_torch.snapshot import packfile
    from backuwup_tpu_torch.snapshot.blob_index import BlobIndex
    from backuwup_tpu_torch.snapshot.unpacker import DirUnpacker
    from backuwup_tpu_torch.utils import zstd
    from backuwup_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    aead = f"{packfile.AESGCM.__module__}.{packfile.AESGCM.__name__}"
    codec = ("zstd level %d (libzstd through ctypes)"
             % defaults.ZSTD_COMPRESSION_LEVEL if zstd.available()
             else "zlib (no libzstd on this host)")
    log(f"pack: AEAD {aead}; codec {codec}; fsync "
        f"{'on' if packfile.durable.FSYNC_ENABLED else 'off'}; seal workers "
        f"{defaults.PACK_SEAL_WORKERS}")
    tmp = Path(tempfile.mkdtemp(prefix="bkw_pack_"))
    try:
        migrate_row = grow_front(torch, rng, tmp / "growth", spec, device,
                                 card, counters)

        # the authority and the hot state at the default budget
        keys = KeyManager.from_secret(rng.bytes(32))
        t0 = time.perf_counter()
        index = BlobIndex(keys, tmp / "repo" / "index")
        synthetic_authority(rng, index, spec["authority"])
        t1 = time.perf_counter()
        front = TieredDedupIndex(index, device=device,
                                 cold_dir=tmp / "repo" / "cold",
                                 hbm_budget_bytes=spec["budget"])
        sync()
        budget = front.hbm_budget_bytes
        hot = int((front.sharded.keys != 0).any(dim=2).sum())
        log(f"pack: authority {len(index)} blobs in {t1 - t0:.1f} s; tiered "
            f"front in {time.perf_counter() - t1:.1f} s: hot table "
            f"{front.capacity} slots ({front.hbm_table_bytes} B of a {budget}"
            f" B budget) seeded with {hot} keys (load "
            f"{hot / front.capacity:.4f}), cold store {len(front.cold)} "
            f"records in {front.cold.run_count} runs [{card}]")
        if front.hbm_table_bytes > budget or not len(front.cold):
            raise AssertionError("the front is not at its cap with a cold "
                                 "tier")
        lost = []  # lost lanes per device batch (the pipeline's hook)
        note = front.note_window

        def counting_note(lanes, n_lost=0):
            lost.append(n_lost)
            note(lanes, n_lost)

        front.note_window = counting_note
        hints = []  # (hashes, flags, cold hits) of each resolve_hints call
        resolve_hints = front.resolve_hints

        def recording_hints(hashes, raw):
            c0 = metric("bkw_tier_hits_total", path="cold")
            flags = resolve_hints(hashes, raw)
            hints.append((hashes, flags,
                          metric("bkw_tier_hits_total", path="cold") - c0))
            return flags

        front.resolve_hints = recording_hints
        backend = GpuBackend(strict_overflow=True, device=device)

        src = tmp / "src"
        t0 = time.perf_counter()
        size_a = write_tree(rng, src / "A", spec["A"], spec)
        log(f"pack: tree A {size_a / MiB:.1f} MiB written in "
            f"{time.perf_counter() - t0:.1f} s")
        host_idx = BlobIndex(keys, tmp / "host" / "index")
        results, sealed = [], []  # sealed: each backup's new packfiles
        for label, size in (("backup 1 (A)", size_a), ("backup 2 (A+B)", 0)):
            if results:
                # between the backups: the recency shift, then tree B
                recency_shift(rng, front, index, a_chunks, spec, card)
                t0 = time.perf_counter()
                size_b = write_tree(rng, src / "B", spec["B"], spec)
                size = size_a + size_b
                log(f"pack: tree B {size_b / MiB:.1f} MiB written in "
                    f"{time.perf_counter() - t0:.1f} s")
            hints.clear()
            lost.clear()
            sealed_before = packfile_ids(tmp / "repo" / "pack")
            host_before = metric("bkw_tier_probes_total", path="host")
            demoted_before = metric("bkw_tier_demotions_total")
            zero_counts(counters)
            root, stats, writer, added, secs = run_backup(
                sync, src, tmp / "repo", keys, index, front, backend,
                spec["batch_bytes"])
            launches = read_counts(counters)
            k5 = (di.insert_table.launches, di.probe_table.launches,
                  di.migrate_round.launches)
            host_root, _hs, _w, _a, host_secs = run_backup(
                sync, src, tmp / "host", keys, host_idx, None, backend,
                spec["batch_bytes"])
            # only its index matters for the next backup: free the disk
            shutil.rmtree(tmp / "host" / "pack", ignore_errors=True)
            st = writer.stage_seconds
            cold_hits = sum(c for _h, _f, c in hints)
            log(f"pack: {label}: {stats.files} files, {stats.dirs} dirs, "
                f"{size / MiB:.1f} MiB in {secs:.3f} s = {size / MiB / secs:.1f}"
                f" MiB/s end to end; {stats.chunks} chunks, "
                f"{stats.chunks_deduped} deduped ({stats.bytes_deduped / MiB:.1f}"
                f" MiB), {len(added)} blobs sealed into "
                f"{writer.bytes_written / MiB:.1f} MiB of packfiles; "
                f"divergences {stats.dedup_divergences} [{card}]")
            log(f"pack: {label}: time split: backend calls (chunk + "
                f"fingerprint + classify on the card, with their host driver)"
                f" {stats.chunk_hash_s:.3f} s; seal (zstd + AES-GCM, summed over"
                f" {defaults.PACK_SEAL_WORKERS} workers) {st['seal']:.3f} s; "
                f"write (assemble + fsync, writer thread) {st['write']:.3f} s; "
                f"packer stalled on the seal queue {st['stall']:.3f} s; device"
                f" busy not measured in this phase [{card}]")
            log(f"pack: {label}: launches {launches} (K5 insert {k5[0]}, "
                f"probe {k5[1]}, migrate {k5[2]}); lost lanes "
                f"{sum(lost)} over {len(lost)} batches; host-resolved hashes "
                f"{int(metric('bkw_tier_probes_total', path='host') - host_before)}"
                f"; cold hits among chunk fingerprints {int(cold_hits)}; "
                f"demotions {int(metric('bkw_tier_demotions_total') - demoted_before)}"
                f" keys; host-only dedup (dedup_index=None) "
                f"{size / MiB / host_secs:.1f} MiB/s [{card}]")
            if root != host_root:
                raise AssertionError(f"{label}: snapshot root differs from the "
                                     "host-only packer's")
            if stats.dedup_divergences or stats.failed_files:
                raise AssertionError(f"{label}: divergences or failed files")
            for name in ("scan_candidates", "blake3_leaf"):
                if launches[name] <= 0:
                    raise AssertionError(f"{label}: kernel {name} not launched")
            if k5[0] <= 0:
                raise AssertionError(f"{label}: K5 insert not launched")
            if front.hbm_table_bytes > budget:
                raise AssertionError(f"{label}: hot table over the budget")
            resolve = resolver(keys, index, tmp / "repo" / "pack")
            files, dirs = file_manifests(resolve, root)
            results.append((root, files, dirs, stats, added, cold_hits))
            sealed.append(sorted(packfile_ids(tmp / "repo" / "pack")
                                 - sealed_before))
            if len(results) == 1:
                a_chunks = {h for hs in files.values() for h in hs}
                n_a_chunks = sum(map(len, files.values()))
        (root1, files1, dirs1, _s1, _a1, _c1), \
            (root2, files2, dirs2, stats2, added2, cold2) = results

        # the second backup: every chunk of A a duplicate, none re-sealed
        if dirs2.get("A") != dirs1.get("A"):
            raise AssertionError("tree A's hash changed between the backups")
        a_hints = [f for hs, fl, _c in hints for h, f in zip(hs, fl)
                   if h in a_chunks]
        if not all(a_hints) or a_chunks & set(added2):
            raise AssertionError("a chunk of A was not a duplicate in backup 2")
        if stats2.chunks_deduped < n_a_chunks:
            raise AssertionError("backup 2 deduped fewer chunks than A holds")
        if metric("bkw_tier_demotions_total") < 1 or cold2 < 1:
            raise AssertionError("no demotion, or no cold hit among real "
                                 "chunk fingerprints")
        high = metric("bkw_tier_hbm_highwater_bytes")
        if high > budget:
            raise AssertionError("the hot table exceeded the budget")
        log(f"pack: backup 2: {len(a_hints)} of A's chunk occurrences carried "
            f"device hints, all duplicates; {n_a_chunks} chunks in A, "
            f"{stats2.chunks_deduped} deduped; none of A's chunks re-sealed; "
            f"cold hits {int(cold2)}; hot-table high water {int(high)} B of "
            f"{budget} B")

        # restore both snapshots and hold the manifests to the oracles
        for k, (root, files, dirs) in enumerate(((root1, files1, dirs1),
                                                 (root2, files2, dirs2))):
            dest = tmp / f"restored{k + 1}"
            t0 = time.perf_counter()
            DirUnpacker(resolver(keys, index, tmp / "repo" / "pack")).unpack(
                root, dest)
            secs = time.perf_counter() - t0
            if k == 0:
                n = same_tree(dest / "A", src / "A")
                if sorted(p.name for p in dest.iterdir()) != ["A"]:
                    raise AssertionError("restore 1 holds more than A")
            else:
                n = same_tree(dest, src)
            log(f"pack: restore {k + 1}: {n / MiB:.1f} MiB byte-identical to "
                f"the source tree, restored in {secs:.1f} s")
            shutil.rmtree(dest)
        rels = sorted(files2)
        streams = [(src / rel).read_bytes() for rel in rels]
        # with ``after`` to run, the oracles run beside it, on all but four
        # cores (the stripe phase's event loop, its device thread and its
        # own two oracle workers keep those): they need only the streams
        workers = min(8, os.cpu_count() or 1)
        if after is not None:
            workers = max(1, workers - 4)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(1) as bg:
            pending = bg.submit(oracle_manifests, streams, backend.params,
                                workers)
            if after is not None:
                after({"tmp": tmp, "keys": keys, "index": index,
                       "pack_dir": tmp / "repo" / "pack",
                       "packfiles": sealed[0], "root": root1,
                       "tree": src / "A"})
            want = pending.result()
        for rel, w in zip(rels, want):
            if [h for _o, _n, h in w] != files2[rel]:
                raise AssertionError(f"{rel}: manifest differs from the oracle")
        log(f"pack: oracle parity: {len(rels)} files, "
            f"{sum(map(len, streams)) / MiB:.1f} MiB, every manifest of "
            f"backup 2 equal to cdc_cpu + blake3_cpu (oracles on {workers} "
            f"processes, done {time.perf_counter() - t0:.1f} s after they "
            f"started{' beside the stripe phase' if after else ''})")
        return migrate_row
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --- 6. the stripe phase: sealed packfiles as erasure stripes on six peers --


def _oracle_containers(path):
    """SHA-256 of each shard container of the packfile at ``path`` as the
    host oracle splits it (``CpuBackend``: numpy GF(2^8), ``blake3_cpu``)."""
    import hashlib

    from backuwup_tpu_torch import defaults
    from backuwup_tpu_torch.erasure import stripe
    from backuwup_tpu_torch.ops.backend import CpuBackend

    return [hashlib.sha256(c).digest() for c in stripe.split_packfile(
        Path(path).read_bytes(), defaults.RS_K, defaults.RS_M, CpuBackend())]


def oracle_containers(paths, workers: int):
    """:func:`_oracle_containers` of each path, on ``workers`` spawned
    processes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(_oracle_containers, paths))


def phase_stripe(torch, rng, card, counters, ctx, device=None,
                 n_packfiles=None):
    """What the engine does to the bytes of every sealed packfile after
    the pack phase (``engine.py`` send, audit, repair and restore paths),
    through the port's entry points and over its network plane: the
    port's ``CoordinationServer`` on ``127.0.0.1`` (port 0, its
    write-behind SQLite store in the phase's temporary directory), and
    one machine per client -- the owner, whose identity is the pack
    phase's keys, and seven holders -- each with its own ``KeyManager``,
    ``Store``, ``ServerClient`` (register, login, push channel) and
    ``P2PNode``, wired as ``ClientApp`` wires them:

    1. matching: the owner asks the server for storage spread over six
       peers, six holders answer with their own requests, and every
       ``BackupMatched`` push is recorded in both stores;
    2. a challenge table of each packfile, ``split_packfile(data, 4, 2,
       GpuBackend())`` and one table per shard container; shard i of
       every stripe to holder i over one ``TRANSPORT`` ``Transport``
       each (signed, acked frames into the holder's ``Receiver`` and
       ``ReceivedFilesWriter``; a stalled ack redials and sends again, as
       ``TransferScheduler.run_resumable`` does); the owner records each
       placement with its shard index; every stored container,
       de-obfuscated, equal to the sent one;
    3. one audit round per holder over an ``AUDIT`` transport (CHALLENGE
       -> the holder's ``serve_audit`` on its ``GpuBackend`` -> PROOF ->
       ``check_proofs`` -> the ledger and ``audit_report``): all pass;
    4. one window of one holder's next challenged shard corrupted on its
       disk: the next round, ``AUDIT_SERVE_MIN_INTERVAL_S`` later, fails
       it, the ledger demotes it out of ``find_peers_with_storage``, the
       other holders pass;
    5. that holder and one more go dark (client and node closed, shards
       deleted); the four survivors' shards pulled over
       ``RESTORE_FETCH``, ``rebuild_shards`` regenerates both lost shards
       of every stripe byte for byte; a seventh holder matched through the
       server takes them over a transport, and ``repair_report`` tells the
       server of each lost peer;
    6. ``backup_done`` with snapshot 1's root, ``backup_restore`` returning
       it and the negotiated peers; the survivors' shards pulled over
       ``RESTORE_FETCH`` into ``RestoreFilesWriter``, then
       ``assemble_tree``; the seventh holder's stored shards equal to the
       rebuilt ones;
    7. every assembled packfile equal to the sealed one, and
       ``DirUnpacker`` over the assembled packs (and the local copies of
       the packfiles the phase did not take) restoring snapshot 1
       byte-identical to its tree; the server's ``/healthz`` and its
       ``bkw_*`` counters.

    Every container is held equal to the host oracle's (``CpuBackend``, in
    worker processes).  The phase takes the first ``n_packfiles`` (all
    when None) of the pack phase's backup 1 (~840 MiB in 246), which
    restore snapshot 1 alone: all of them without the network took 303.5
    s on an NVIDIA H100 80GB HBM3 at 700.00 W, ~2,964 ``digest_many``
    calls at ~88 ms each (PERF.md §5).  Returns the K2/K6 launches of the
    phase."""
    import asyncio
    import gc
    import hashlib
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from backuwup_tpu_torch import defaults, wire
    from backuwup_tpu_torch.audit import (build_challenge_table,
                                          check_proofs, record_fail,
                                          record_pass, select_challenges)
    from backuwup_tpu_torch.crypto import KeyManager
    from backuwup_tpu_torch.erasure import rs_gpu
    from backuwup_tpu_torch.erasure import stripe as rs_stripe
    from backuwup_tpu_torch.net import p2p
    from backuwup_tpu_torch.net.p2p import (ReceivedFilesWriter, Receiver,
                                            RestoreFilesWriter)
    from backuwup_tpu_torch.net.server import CoordinationServer
    from backuwup_tpu_torch.net.transfer import TransferScheduler
    from backuwup_tpu_torch.ops.backend import GpuBackend
    from backuwup_tpu_torch.snapshot.blob_index import ChallengeTable
    from backuwup_tpu_torch.snapshot.packfile import packfile_path
    from backuwup_tpu_torch.snapshot.unpacker import DirUnpacker
    from backuwup_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cuda = device.type == "cuda"
    k, m = defaults.RS_K, defaults.RS_M
    SHARD = wire.FileInfoKind.SHARD
    tmp, keys, pack_dir = ctx["tmp"] / "stripe", ctx["keys"], ctx["pack_dir"]
    sealed = [(pid, packfile_path(pack_dir, pid)) for pid in ctx["packfiles"]]
    packs = sealed[:n_packfiles]
    total = sum(p.stat().st_size for _pid, p in packs)
    sizes = [p.stat().st_size for _pid, p in packs]
    log(f"stripe: {len(packs)} of the {len(sealed)} packfiles of backup 1, "
        f"{total / MiB:.1f} MiB (sizes "
        f"{min(sizes)}-{max(sizes)} B), RS({k}, {m}) over {k + m} peers "
        f"matched by the port's coordination server, over its P2P "
        f"transport")

    gpu = GpuBackend(device=device)  # the owner's
    prover = GpuBackend(device=device)  # the holders' (one card here)
    calls = []  # host seconds of each digest_many call

    def timing(backend):
        digest_many = backend.digest_many

        def timed_digest_many(datas):
            t0 = time.perf_counter()
            out = digest_many(datas)
            calls.append(time.perf_counter() - t0)
            return out

        backend.digest_many = timed_digest_many

    timing(gpu)
    timing(prover)
    k6_events = []  # CUDA events around each K6 launch
    kernel = rs_gpu.gf_matmul

    def timed_gf_matmul(mat, stripes):
        if not cuda:
            return kernel(mat, stripes)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = kernel(mat, stripes)
        b.record()
        k6_events.append((a, b))
        return out

    frames = {"n": 0, "bytes": 0}  # every signed frame a Transport ships
    ship = p2p.Transport._ship

    async def counted_ship(self, raw, *args, **kw):
        frames["n"] += 1
        frames["bytes"] += len(raw)
        return await ship(self, raw, *args, **kw)

    host_b3 = []  # seconds of each host BLAKE3 of a chunked send's file
    blake3_many = p2p.blake3_many

    def timed_blake3_many(datas):
        t0 = time.perf_counter()
        out = blake3_many(datas)
        host_b3.append(time.perf_counter() - t0)
        return out

    redials, refetched = [], []  # sessions dialed again, wants asked again
    # how a session ends when its other side gave up on it
    closed = (p2p.P2PError, p2p.websockets.ConnectionClosed)
    lag = {"max": 0.0, "over_1s": 0}  # the event loop's late wake-ups
    sinks = []  # seconds of each holder's ReceivedFilesWriter.sink
    gc_pauses = []  # (generation, seconds) of each collection in the phase
    gc_start = {}

    def on_gc(phase, info):
        if phase == "start":
            gc_start["t"] = time.perf_counter()
        elif "t" in gc_start:
            gc_pauses.append((info["generation"],
                              time.perf_counter() - gc_start.pop("t")))

    def transport_state():
        """One line on the transports so far (logged as delivery goes and
        when the phase fails)."""
        sink_ms = (f"median {statistics.median(sinks) * 1e3:.3f} ms, max "
                   f"{max(sinks) * 1e3:.3f} ms" if sinks else "none yet")
        return (f"{frames['n']} signed frames, {frames['bytes']} B through "
                f"Transport._ship; {len(redials)} sessions redialed after a "
                f"stalled ack, wants asked again {refetched}; holders' "
                f"sinks {len(sinks)}, {sink_ms}; event loop woken late by up "
                f"to {lag['max'] * 1e3:.1f} ms ({lag['over_1s']} times over "
                f"1 s); host BLAKE3 of files over "
                f"{defaults.TRANSFER_CHUNK_BYTES} B (chunked sends, partials, "
                f"resume offers) {len(host_b3)} calls, {sum(host_b3):.3f} s; "
                f"{len(gc_pauses)} garbage collections, "
                f"{sum(s for _g, s in gc_pauses):.3f} s, the longest "
                f"{max(gc_pauses, default=(0, 0.0), key=lambda g: g[1])}")

    class Machine:
        """One client on its own machine, wired as ``ClientApp`` wires
        it: identity, store, control-plane client and P2P node."""

        def __init__(self, name, mkeys, addr):
            from backuwup_tpu_torch.net.client import ServerClient
            from backuwup_tpu_torch.net.p2p import P2PNode
            from backuwup_tpu_torch.store import Store

            self.name, self.keys, self.id = name, mkeys, mkeys.client_id
            self.store = Store(tmp / name / "cfg",
                               data_base=tmp / name / "data")
            self.client = ServerClient(mkeys, self.store, addr=addr,
                                       tls=False)
            self.node = P2PNode(mkeys, self.store, self.client)
            self.client.on_backup_matched = self.matched
            self.stored = 0  # files its Receivers stored for others

        async def matched(self, msg):
            self.store.add_peer_negotiated(msg.destination_id,
                                           msg.storage_available)

        async def join(self):
            await self.client.register()
            await self.client.login()
            self.client.start_ws()
            await asyncio.wait_for(self.client.ws_connected.wait(), 30)

        def hold(self):
            """Serve as a holder: store what a matched peer sends, answer
            its audits on the holder's ``GpuBackend`` and its fetches."""
            self.store.set_obfuscation_key(rng.bytes(4))

            async def accept(source, transport):
                writer = ReceivedFilesWriter(self.store, source)
                sink = writer.sink

                async def timed_sink(*args):
                    t0 = time.perf_counter()
                    await sink(*args)
                    sinks.append(time.perf_counter() - t0)

                writer.sink = timed_sink  # sink_part's final write too
                try:
                    self.stored += await Receiver(
                        transport, writer.sink, part_sink=writer.sink_part,
                        resume_query=writer.resume_offer).run()
                except closed:
                    pass  # the owner dropped the session (a stalled ack)

            async def audit(source, transport):
                await self.node.serve_audit(source, transport, prover)

            self.node.on_transport_request = accept
            self.node.on_audit_request = audit
            self.node.on_restore_fetch_request = \
                self.node.serve_restore_fetch

        async def close(self):
            await self.client.close()
            self.store.close()

    # the host oracle splits the same packfiles from disk on two worker
    # processes beside the phase
    t_oracle = time.perf_counter()
    background = ThreadPoolExecutor(1)
    oracle = background.submit(oracle_containers,
                               [str(p) for _pid, p in packs], 2)
    sha = {}  # sha256 of each packfile's six containers
    steps = {}  # wall seconds of each step
    out = {}

    async def wait_until(cond, what, timeout=60.0):
        t0 = time.perf_counter()
        while not cond():
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"timed out waiting for {what}")
            await asyncio.sleep(0.02)

    async def match(owner, holders, grant):
        """The owner asks for ``grant`` on each of ``len(holders)`` peers;
        each holder answers with a request of ``grant``."""
        await owner.client.backup_storage_request(
            grant * len(holders), min_peers=len(holders))
        for h in holders:
            await h.client.backup_storage_request(grant)
        await wait_until(lambda: all(
            owner.store.get_peer(h.id) is not None
            and h.store.get_peer(owner.id) is not None for h in holders),
            "BackupMatched pushes")
        for h in holders:
            if owner.store.get_peer(h.id).bytes_negotiated != grant or \
                    h.store.get_peer(owner.id).bytes_negotiated != grant:
                raise AssertionError(f"{h.name}: negotiated bytes differ "
                                     f"from the grant {grant}")

    async def connect(owner, h, purpose):
        return await owner.node.connect(h.id, purpose, timeout=30.0)

    class Link:
        """The owner's TRANSPORT session to one holder, sent on as the
        engine sends (``TransferScheduler.run_resumable``): a stalled ack
        drops the session, a new one is dialed through the server, and
        the file goes again (a chunked one from the verified offset)."""

        def __init__(self, owner, h):
            self.owner, self.h, self.t = owner, h, None

        async def redial(self):
            self.t = await connect(self.owner, self.h,
                                   wire.RequestType.TRANSPORT)
            return self.t

        async def drop(self):
            redials.append(self.h.name)
            await self.t.close()

        async def send(self, fid, blob):
            if self.t is None:
                await self.redial()
            await TransferScheduler.run_resumable(
                self.t, self.h.id, blob, SHARD, fid, redial=self.redial,
                on_drop=self.drop)

        async def close(self):
            if self.t is not None:
                await self.t.close()

    async def audit(owner, tables, h, rtts):
        """``Engine.audit_peer`` against holder ``h``: CHALLENGE over an
        AUDIT transport, the PROOF checked, the verdict in the ledger and
        reported to the server."""
        challenges, expected = select_challenges(owner.store, tables, h.id)
        t0 = time.perf_counter()
        t = await connect(owner, h, wire.RequestType.AUDIT)
        try:
            seq = t.seq
            t.seq += 1
            await t.send_body(wire.P2PBody(
                kind=wire.P2PBodyKind.CHALLENGE,
                header=wire.P2PHeader(sequence_number=seq,
                                      session_nonce=t.session_nonce),
                challenges=tuple(challenges)))
            reply = await t.recv_body(defaults.AUDIT_PROOF_TIMEOUT_S)
        finally:
            await t.close()
        rtts.append(time.perf_counter() - t0)
        if reply.kind != wire.P2PBodyKind.PROOF or \
                reply.header.sequence_number != seq:
            raise AssertionError(f"{h.name}: bad or replayed proof body")
        res = check_proofs(challenges, expected, reply.proofs)
        if res.passed:
            state = record_pass(owner.store, h.id)
        else:
            state = record_fail(owner.store, h.id, res.detail)
        await owner.client.audit_report(h.id, res.passed, res.detail)
        return res, state

    async def fetch(owner, h, wants, writer, root):
        """``RESTORE_FETCH`` pulls of ``wants`` from holder ``h`` into
        ``writer`` (whose tree is ``root``), the wants that did not land
        asked again up to twice (the engine's ``RESTORE_FETCH_RETRIES``,
        ``backuwup_tpu/defaults.py:145``), as its pull re-queues them;
        returns the files received."""
        got = 0
        for _attempt in range(3):
            missing = [(kind, fid) for kind, fid in wants if not (
                root / "shard" / fid[:-1].hex() / f"{fid[-1]:03d}").exists()]
            if not missing:
                break
            if _attempt:
                refetched.append((h.name, len(missing)))
            t = await connect(owner, h, wire.RequestType.RESTORE_FETCH)
            try:
                await owner.node.request_fetch(t, missing)
                got += await asyncio.wait_for(Receiver(
                    t, writer.sink, part_sink=writer.sink_part,
                    resume_query=writer.resume_offer).run(), 900)
            except closed:
                pass  # the holder gave up on a stalled ack: ask again
            finally:
                await t.close()
        if any(not (root / "shard" / fid[:-1].hex()
                    / f"{fid[-1]:03d}").exists() for _kind, fid in wants):
            raise AssertionError(f"{h.name} did not return every want")
        return got

    def prepare(pid, path, tables):
        """Tables and split of one packfile (the owner's device work)."""
        data = path.read_bytes()
        t0 = time.perf_counter()
        tables.save(pid, build_challenge_table(gpu, data))
        t1 = time.perf_counter()
        containers = rs_stripe.split_packfile(data, k, m, gpu)
        t2 = time.perf_counter()
        for i, blob in enumerate(containers):
            tables.save(rs_stripe.shard_id(pid, i),
                        build_challenge_table(gpu, blob))
        sha[pid] = [hashlib.sha256(b).digest() for b in containers]
        return containers, (t1 - t0) + (time.perf_counter() - t2), t2 - t1

    def check_stored(h, owner_id, want):
        """Holder ``h``'s stored shards, de-obfuscated: ``want`` maps each
        shard id to the sha256 of the container sent."""
        got = {fid: hashlib.sha256(data).digest() for _kind, fid, data
               in ReceivedFilesWriter(h.store, owner_id).iter_stored()}
        if got != want:
            raise AssertionError(f"{h.name}: stored containers differ "
                                 "from the ones sent")
        return len(got)

    def fetched(root, pid, i):
        return (root / "shard" / pid.hex() / f"{i:03d}").read_bytes()

    async def watch_loop():
        """How late the event loop wakes a 50 ms sleeper: a stalled loop
        (or host) delays every transport's frames and acks alike."""
        while True:
            t0 = time.perf_counter()
            await asyncio.sleep(0.05)
            late = time.perf_counter() - t0 - 0.05
            lag["max"] = max(lag["max"], late)
            lag["over_1s"] += late > 1.0

    async def run():
        watcher = asyncio.create_task(watch_loop())
        (tmp / "server").mkdir(parents=True)
        server = CoordinationServer(db_path=tmp / "server" / "server.db")
        port = await server.start(host="127.0.0.1", port=0)
        addr = f"127.0.0.1:{port}"
        owner = Machine("owner", keys, addr)
        holders = [Machine(f"peer{i}", KeyManager.from_secret(rng.bytes(32)),
                           addr) for i in range(k + m + 1)]
        machines = [owner] + holders
        try:
            # 1. identities and matching
            t0 = time.perf_counter()
            for mc in machines:
                await mc.join()
            for h in holders:
                h.hold()
            tables = ChallengeTable(keys, owner.store.challenge_dir())
            # each holder stores one shard of every stripe, a quarter of
            # the packfile bytes plus headers; the seventh two of them
            grant = total + 64 * MiB
            stripe_holders, spare = holders[:k + m], holders[k + m]
            await match(owner, stripe_holders, grant)
            steps["join + match"] = time.perf_counter() - t0
            log(f"stripe: server on {addr} (write-behind SQLite store); "
                f"{len(machines)} clients registered, logged in and on the "
                f"push channel; the owner matched with {k + m} holders at "
                f"{grant} B each, every BackupMatched recorded on both "
                f"sides, in {steps['join + match']:.3f} s")

            # 2. tables, split, and delivery over one transport per holder
            t0 = time.perf_counter()
            links = [Link(owner, h) for h in stripe_holders]
            t_split = t_tables = t_send = 0.0
            sent_bytes = 0
            for n, (pid, path) in enumerate(packs):
                if n and n % 64 == 0:
                    log(f"stripe: {n} packfiles delivered, "
                        f"{time.perf_counter() - t0:.1f} s; "
                        + transport_state())
                containers, dt_tables, dt_split = await asyncio.to_thread(
                    prepare, pid, path, tables)
                t_tables += dt_tables
                t_split += dt_split
                t1 = time.perf_counter()
                # one holder after another: a shard over
                # TRANSFER_CHUNK_BYTES costs a host BLAKE3 on each side,
                # and concurrent ones in this one process share its
                # interpreter lock past the last part's ack deadline
                for i, (link, blob) in enumerate(zip(links, containers)):
                    await link.send(rs_stripe.shard_id(pid, i), blob)
                t_send += time.perf_counter() - t1
                for i, blob in enumerate(containers):
                    h = stripe_holders[i]
                    owner.store.add_peer_transmitted(h.id, len(blob))
                    owner.store.record_placement(pid, h.id, len(blob),
                                                 shard_index=i)
                    sent_bytes += len(blob)
            for link in links:
                await link.close()
            # a file sent again after a stalled ack is stored once and
            # counted by both sessions' Receivers
            await wait_until(lambda: sum(h.stored for h in stripe_holders)
                             >= (k + m) * len(packs), "holders' Receivers")
            steps["split + tables + delivery"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            n_stored = 0
            for i, h in enumerate(stripe_holders):
                n_stored += await asyncio.to_thread(
                    check_stored, h, owner.id,
                    {rs_stripe.shard_id(pid, i): sha[pid][i]
                     for pid, _p in packs})
            out["n_split_calls"] = len(calls)
            log(f"stripe: split {len(packs)} packfiles ({total / MiB:.1f} "
                f"MiB) in {t_split:.3f} s = {total / MiB / t_split:.1f} "
                f"MiB/s; {7 * len(packs)} challenge tables in "
                f"{t_tables:.3f} s; {(k + m) * len(packs)} shard containers "
                f"({sent_bytes / MiB:.1f} MiB) delivered to {k + m} holders "
                f"over signed transports in {t_send:.3f} s = "
                f"{sent_bytes / MiB / t_send:.1f} MiB/s; "
                f"{frames['n']} frames, {frames['bytes']} B shipped, "
                f"{int(metric('bkw_transfer_parts_total'))} of them FILE_PART "
                f"frames of chunked sends; {len(redials)} sessions redialed "
                f"after a stalled ack ({sorted(set(redials))}); the step "
                f"{steps['split + tables + delivery']:.3f} s; {n_stored} "
                f"stored containers, de-obfuscated, equal to the sent ones "
                f"(checked in {time.perf_counter() - t1:.3f} s) [{card}]")

            # 3. one audit round per holder over the wire: all pass
            t0 = time.perf_counter()
            rtts = []
            for h in stripe_holders:
                res, _state = await audit(owner, tables, h, rtts)
                if not res.passed or res.checked != \
                        defaults.AUDIT_SAMPLES_PER_ROUND:
                    raise AssertionError(f"{h.name} failed its audit: "
                                         f"{res.detail}")
            steps["audit round 1"] = time.perf_counter() - t0
            round1_end = time.time()
            log(f"stripe: audit round 1 over AUDIT transports: {k + m} "
                f"holders, {defaults.AUDIT_SAMPLES_PER_ROUND} challenges "
                f"each, all pass; round trip median "
                f"{statistics.median(rtts) * 1e3:.3f} ms, max "
                f"{max(rtts) * 1e3:.3f} ms; round "
                f"{steps['audit round 1']:.3f} s [{card}]")

            # 4. corrupt one window of holder 1's next challenged shard
            bad, dark = 1, (1, 4)
            bad_h = stripe_holders[bad]
            first_pid, _size, idx = owner.store.shard_placements_for_peer(
                bad_h.id)[0]
            sid = first_pid + bytes([idx])
            entry = tables.load(sid)[owner.store.get_audit_cursor(sid)]
            target = bad_h.store.received_dir(owner.id) / "shard" / sid.hex()
            raw = bytearray(target.read_bytes())
            raw[entry.offset + entry.length // 2] ^= 0xFF
            target.write_bytes(bytes(raw))
            # a holder serves one audit per peer per interval
            await asyncio.sleep(max(0.0, round1_end + 0.5 - time.time()
                                    + defaults.AUDIT_SERVE_MIN_INTERVAL_S))
            t0 = time.perf_counter()
            rtts2 = []
            for i, h in enumerate(stripe_holders):
                res, state = await audit(owner, tables, h, rtts2)
                if i == bad:
                    if res.passed or "digest mismatch" not in res.detail:
                        raise AssertionError("the corrupted window passed")
                    bad_state = state
                elif not res.passed:
                    raise AssertionError(f"{h.name} failed round 2: "
                                         f"{res.detail}")
            steps["audit round 2"] = time.perf_counter() - t0
            listed = [p.pubkey for p in owner.store.find_peers_with_storage()]
            if not bad_state.demoted or bad_h.id in listed or \
                    len(listed) != k + m - 1:
                raise AssertionError("the failing holder was not demoted")
            log(f"stripe: audit round 2 ({defaults.AUDIT_SERVE_MIN_INTERVAL_S}"
                f" s after round 1 ended, the holders' rate limit): "
                f"{bad_h.name}'s "
                f"corrupted window detected ({bad_state.last_result[:60]}"
                f"...), demoted, out of find_peers_with_storage "
                f"({len(listed)} peers left); the others pass; round trip "
                f"median {statistics.median(rtts2) * 1e3:.3f} ms; round "
                f"{steps['audit round 2']:.3f} s")

            # 5. holders 1 and 4 go dark; the survivors' shards pulled,
            # the lost ones rebuilt and re-homed on a seventh holder
            t0 = time.perf_counter()
            for i in dark:
                await stripe_holders[i].close()
                shutil.rmtree(stripe_holders[i].store.data_base
                              / "received_packfiles")
            alive = [i for i in range(k + m) if i not in dark]
            staging = RestoreFilesWriter(owner.store, base=tmp / "repair")
            t1 = time.perf_counter()
            for i in alive:
                await fetch(owner, stripe_holders[i],
                            [(SHARD, rs_stripe.shard_id(pid, i))
                             for pid, _p in packs], staging, tmp / "repair")
            t_repair_pull = time.perf_counter() - t1
            calls_before = len(calls)
            t_rebuild = 0.0
            rebuilt_all = {}
            for pid, _path in packs:
                def rebuild():
                    blobs = [fetched(tmp / "repair", pid, i) for i in alive]
                    return rs_stripe.rebuild_shards(blobs, list(dark), gpu)
                t1 = time.perf_counter()
                rebuilt = await asyncio.to_thread(rebuild)
                t_rebuild += time.perf_counter() - t1
                for i in dark:
                    if hashlib.sha256(rebuilt[i]).digest() != sha[pid][i]:
                        raise AssertionError(f"rebuilt shard {i} of "
                                             f"{pid.hex()} differs")
                rebuilt_all[pid] = rebuilt
            out["n_rebuild_calls"] = len(calls) - calls_before
            shutil.rmtree(tmp / "repair")
            lost_bytes = {i: sum(len(r[i]) for r in rebuilt_all.values())
                          for i in dark}
            await spare.client.backup_storage_request(grant)
            await owner.client.backup_storage_request(grant)
            await wait_until(
                lambda: owner.store.get_peer(spare.id) is not None
                and spare.store.get_peer(owner.id) is not None,
                "the seventh holder's BackupMatched")
            t1 = time.perf_counter()
            link = Link(owner, spare)
            try:
                for pid, r in rebuilt_all.items():
                    for i in dark:
                        await link.send(rs_stripe.shard_id(pid, i), r[i])
            finally:
                await link.close()
            await wait_until(lambda: spare.stored >= len(dark) * len(packs),
                             "the seventh holder's Receiver")
            t_rehome = time.perf_counter() - t1
            for i in dark:
                lost = stripe_holders[i]
                owner.store.retire_placements(lost.id)
                await owner.client.repair_report(
                    lost.id, len(packs), lost_bytes[i], lost_bytes[i])
            for pid, r in rebuilt_all.items():
                for i in dark:
                    owner.store.add_peer_transmitted(spare.id, len(r[i]))
                    owner.store.record_placement(pid, spare.id, len(r[i]),
                                                 shard_index=i)
            del rebuilt_all
            steps["repair"] = time.perf_counter() - t0
            rehomed = sum(lost_bytes.values())
            log(f"stripe: repair: holders {list(dark)} dark; shards "
                f"{alive} of {len(packs)} stripes pulled over RESTORE_FETCH "
                f"in {t_repair_pull:.3f} s = "
                f"{len(alive) * total / 4 / MiB / t_repair_pull:.1f} MiB/s; "
                f"rebuild of shards {list(dark)} {t_rebuild:.3f} s = "
                f"{total / MiB / t_rebuild:.1f} MiB/s of packfile, every "
                f"rebuilt container byte-identical to the original; "
                f"{2 * len(packs)} rebuilt shards ({rehomed / MiB:.1f} MiB) "
                f"re-homed on {spare.name}, matched through the server, in "
                f"{t_rehome:.3f} s = {rehomed / MiB / t_rehome:.1f} MiB/s; "
                f"repair_report for both; the step {steps['repair']:.3f} s "
                f"[{card}]")

            # 6. restore: the server's record, then the pull
            t0 = time.perf_counter()
            await owner.client.backup_done(ctx["root"])
            info = await owner.client.backup_restore()
            want_peers = {stripe_holders[i].id.hex() for i in alive} \
                | {spare.id.hex()}
            if info.snapshot_hash != ctx["root"] or \
                    set(info.peers) != want_peers:
                raise AssertionError(f"backup_restore returned "
                                     f"{info.snapshot_hash!r}, {info.peers}")
            restore = tmp / "restore"
            writer = RestoreFilesWriter(owner.store, base=restore)
            t1 = time.perf_counter()
            got = [await fetch(
                owner, stripe_holders[i],
                [(SHARD, rs_stripe.shard_id(pid, i)) for pid, _p in packs],
                writer, restore) for i in alive]
            t_pull = time.perf_counter() - t1
            pulled = sum(len(fetched(restore, pid, i))
                         for pid, _p in packs for i in alive)
            calls_before = len(calls)
            t1 = time.perf_counter()
            done, failed = await asyncio.to_thread(
                rs_stripe.assemble_tree, restore / "shard", restore / "pack",
                gpu)
            t_assemble = time.perf_counter() - t1
            out["n_assemble_calls"] = len(calls) - calls_before
            if failed or sorted(done) != sorted(pid for pid, _p in packs):
                raise AssertionError(f"assemble_tree failed: {failed[:3]}")
            steps["restore"] = time.perf_counter() - t0
            log(f"stripe: restore: the server returned snapshot "
                f"{info.snapshot_hash.hex()[:16]}... and "
                f"{len(info.peers)} negotiated peers; {sum(got)} shards "
                f"({pulled / MiB:.1f} MiB) pulled from {len(alive)} holders "
                f"over RESTORE_FETCH in {t_pull:.3f} s = "
                f"{pulled / MiB / t_pull:.1f} MiB/s; assemble_tree "
                f"{len(done)} packfiles in {t_assemble:.3f} s = "
                f"{total / MiB / t_assemble:.1f} MiB/s; the step "
                f"{steps['restore']:.3f} s [{card}]")
            # the seventh holder stores the rebuilt shards
            n = await asyncio.to_thread(
                check_stored, spare, owner.id,
                {rs_stripe.shard_id(pid, i): sha[pid][i]
                 for pid, _p in packs for i in dark})
            log(f"stripe: {spare.name}'s {n} stored shards, de-obfuscated, "
                f"equal to the rebuilt ones")

            # the server's view
            import aiohttp

            async with aiohttp.ClientSession() as http:
                async with http.get(f"http://{addr}/healthz") as r:
                    health = (r.status, await r.json())
                async with http.get(f"http://{addr}/metrics") as r:
                    text = await r.text()
            lines = [ln for ln in text.splitlines() if ln.startswith((
                "bkw_matchmakings_total", "bkw_server_requests_total"))
                and any(s in ln for s in ("matchmakings", "/backups/request",
                                          "/audit/report", "/repair/report",
                                          "/p2p/connection/begin",
                                          "/backups/restore"))]
            log(f"stripe: server /healthz {health[0]} status "
                f"{health[1].get('status')}; /metrics: " + "; ".join(lines))
            if health[0] != 200:
                raise AssertionError(f"/healthz answered {health[0]}")
            out["restore"] = restore
        finally:
            for mc in machines:
                await mc.close()
            await server.stop()
            watcher.cancel()

    zero_counts(counters)
    # the wrapper counts its launches on the module's ``gf_matmul``, which
    # the timing hook stands in for during the phase; the count goes back
    # to the wrapper after it
    timed_gf_matmul.launches = 0
    rs_gpu.gf_matmul = timed_gf_matmul
    p2p.Transport._ship = counted_ship
    p2p.blake3_many = timed_blake3_many
    gc.callbacks.append(on_gc)
    # the heap the phases before leave in this one process (the pack
    # phase's 6,000,000-blob index among it) stays out of collections: a
    # full collection over it paused the event loop 6.8 s, past the 5 s
    # ack deadline (PERF.md §6)
    gc.freeze()
    try:
        if cuda:
            torch.cuda.synchronize()
        t_phase = time.perf_counter()
        try:
            asyncio.run(run())
        except BaseException:
            log(f"stripe: failed after {time.perf_counter() - t_phase:.1f} "
                f"s, steps {steps}; " + transport_state())
            raise
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t_phase
    finally:
        p2p.Transport._ship = ship
        p2p.blake3_many = blake3_many
        gc.callbacks.remove(on_gc)
        gc.unfreeze()
        rs_gpu.gf_matmul = kernel
        kernel.launches += timed_gf_matmul.launches
    launches = read_counts(counters)
    k6_ms = [a.elapsed_time(b) for a, b in k6_events]

    # 7. the assembled packfiles and the tree they restore
    restore = out["restore"]
    for pid, path in packs:
        if packfile_path(restore / "pack", pid).read_bytes() != \
                path.read_bytes():
            raise AssertionError(f"assembled {pid.hex()} differs")
    # the packfiles the phase did not take restore from the local copies
    for pid, path in sealed[len(packs):]:
        dst = packfile_path(restore / "pack", pid)
        dst.parent.mkdir(parents=True, exist_ok=True)
        os.link(path, dst)
    root, tree = ctx["root"], ctx["tree"]
    dest = tmp / "restored1"
    t0 = time.perf_counter()
    DirUnpacker(resolver(keys, ctx["index"], restore / "pack")).unpack(
        root, dest)
    n = same_tree(dest / tree.name, tree)
    if sorted(p.name for p in dest.iterdir()) != [tree.name]:
        raise AssertionError("the stripe restore holds more than its tree")
    log(f"stripe: snapshot 1 ({root.hex()[:16]}...) restored from the "
        f"{len(packs)} assembled packfiles and {len(sealed) - len(packs)} "
        f"local ones, {n / MiB:.1f} MiB byte-identical to its tree, in "
        f"{time.perf_counter() - t0:.1f} s")
    shutil.rmtree(dest)

    # every container equal to the host oracle's
    want = oracle.result()
    background.shutdown()
    for (pid, _p), w in zip(packs, want):
        if sha[pid] != w:
            raise AssertionError(f"containers of {pid.hex()} differ from "
                                 "the host oracle's")
    log(f"stripe: oracle parity: {6 * len(packs)} shard containers equal "
        f"to CpuBackend's (numpy GF(2^8) + blake3_cpu on 2 processes beside "
        f"the phase, done {time.perf_counter() - t_oracle:.1f} s after they "
        f"started)")

    med = statistics.median(calls) * 1e3
    log(f"stripe: phase wall {wall:.3f} s for {total / MiB:.1f} MiB ("
        + ", ".join(f"{name} {s:.3f} s" for name, s in steps.items())
        + f"); launches {launches}; digest_many {len(calls)} calls "
        f"({out['n_split_calls']} in split + tables, "
        f"{out['n_rebuild_calls']} in rebuild, {out['n_assemble_calls']} in "
        f"assemble, the rest in audits), "
        f"{sum(calls):.3f} s in all, per call median {med:.3f} ms, mean "
        f"{sum(calls) / len(calls) * 1e3:.3f} ms, max {max(calls) * 1e3:.3f}"
        f" ms; " + transport_state() + "; "
        f"K6 {len(k6_ms)} launches, "
        + (f"{sum(k6_ms):.3f} ms of device time in all (median "
           f"{statistics.median(k6_ms):.4f} ms per launch)" if k6_ms
           else "device time not measured (not on the card)")
        + f" [{card}]")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} not launched on the stripe "
                                 "path")
    return launches


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
    from backuwup_tpu_torch.erasure import rs_gpu
    from backuwup_tpu_torch.ops import blake3_gpu, dedup_index, scan_fused
    from backuwup_tpu_torch.ops.backend import GpuBackend
    from backuwup_tpu_torch.ops.gear import CDCParams
    from backuwup_tpu_torch.snapshot.device_dedup import MeshDedupIndex

    t_start = time.perf_counter()

    def mark(label):
        log(f"[{time.perf_counter() - t_start:.1f} s] {label} done")

    # 1. build + device
    t0 = time.perf_counter()
    reports = kernels.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s into {kernels.build_dir()}")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if any(k in line for k in ("registers", "spill", "stack frame")):
                log(f"ptxas {name}: {line.strip()}")
    log_sass(kernels.build_dir(), ("scan_candidates", "dedup_probe",
                                   "gear_values", "ladder_candidates",
                                   "gf_matmul"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    log_network_packages()
    log_host(torch)

    rng = np.random.default_rng(args.seed)
    # 2. kernels vs plain at full width
    rows = phase_kernels(torch, rng, card)
    mark("K1/K2 phase")
    torch.cuda.empty_cache()

    # the phases added after the first slice draw from their own stream,
    # so the corpus below stays the one earlier runs measured
    rng_k = np.random.default_rng([args.seed, 2])
    rows += phase_gear_ladder(torch, rng_k, card)
    mark("K3/K4 phase")
    torch.cuda.empty_cache()
    dedup_row, probe_row = phase_dedup(torch, rng_k, card)
    mark("K5 phase")
    torch.cuda.empty_cache()
    gf_row = phase_gf(torch, np.random.default_rng([args.seed, 4]), card)
    mark("K6 phase")
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
    rows += [dedup_row, probe_row]
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

    mark("main path")
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
    del corpus, main_out, part, got, streams, want, long_data
    torch.cuda.empty_cache()

    mark("oracle parity")
    # 5. the pack phase: the backup data plane from a directory to sealed
    # packfiles and back, at a real user's size; 6. the stripe phase over
    # the packfiles it sealed
    stripe_counters = {"blake3_leaf": (blake3_gpu.leaf_scan,),
                       "gf_matmul": (rs_gpu.gf_matmul,)}
    stripe_launches, stripe_secs = {}, []

    def stripe(ctx):
        t1 = time.perf_counter()
        stripe_launches.update(phase_stripe(
            torch, np.random.default_rng([args.seed, 5]), card,
            stripe_counters, ctx, n_packfiles=STRIPE_PACKFILES))
        stripe_secs.append(time.perf_counter() - t1)

    t0 = time.perf_counter()
    rows.append(phase_pack(torch, np.random.default_rng([args.seed, 3]),
                           card, counters, after=stripe))
    log(f"pack phase with the stripe phase: {time.perf_counter() - t0:.1f} s"
        f" (stripe phase {stripe_secs[0]:.1f} s)")
    gf_row["launches"] = stripe_launches["gf_matmul"]
    rows.append(gf_row)
    mark("pack and stripe phases")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
