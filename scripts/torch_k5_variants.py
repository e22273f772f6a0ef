#!/usr/bin/env python3
"""Timing trial of the dedup table's probe and migration (K5) on one card.

    python3 scripts/torch_k5_variants.py [--reps N]

Builds ``scripts/torch_k5_variants.cu`` into ``build/k5_variants/``: the
probe and the migration round the port had before their redesign, the
port's group probe with 8 lanes a query and with windows aligned in
memory (the port's are 4 lanes, windows from the start slot), one thread
per query over the port's 4-slot walk, the port's migration with a
%globaltimer stamp at each barrier, and a yardstick kernel.  The port's
own kernels come from ``backuwup_tpu_torch``.  On a table of 2^23 slots
filled to load 0.25, 0.5
and 0.75 it checks every probe bit-exact against the plain probe and times
2^20 queries (half resident) per call of 20 queued back to back behind a
sleep, in turns, beside the yardstick (each query's start-slot key row and
every other query's value, one thread per query: the random accesses of
walks that all end at their first slot).  Then it grows a 2^21-slot table
at load 0.5 to 2^23 slots with the port's one launch and with the rounds
of three launches and a host read that the port had before (tables
bit-identical), timing the launch between CUDA events and each whole
growth by the host's clock and CUDA events in turns, and prints the
migration's time per phase and round.  Prints the card's name and power
limit.  Not part of the port.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# probe variants of scripts/torch_k5_variants.cu, by C entry point
VARIANTS = {"g4 aligned": "bkw_probe_g4_aligned",
            "g8 aligned": "bkw_probe_g8_aligned",
            "g8 from the start slot": "bkw_probe_g8_unaligned",
            "one thread per query, 4-slot walk": "bkw_probe_one_wide",
            "one thread per query (before)": "bkw_probe_before"}


def build() -> Path:
    from backuwup_tpu_torch import kernels

    out = REPO / "build" / "k5_variants"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libvariants.so"
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS,
         str(REPO / "scripts" / "torch_k5_variants.cu"), "-o", str(lib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=600)
    if proc.returncode:
        raise RuntimeError(f"build of the variants failed:\n{proc.stdout}")
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from backuwup_tpu_torch.ops import dedup_index as di

    path = build()
    cs.log_sass(path.parent, ("variants",))
    vp, ll, ui, ci = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
                      ctypes.c_int)
    before = ctypes.CDLL(str(path))
    for entry in VARIANTS.values():
        getattr(before, entry).argtypes = [vp, vp, vp, ll, ui, ui, ci, vp, vp]
    before.bkw_migrate_round_before.argtypes = [vp, vp, ll, ui, vp, vp, ui,
                                                ci, vp, vp, vp, vp, vp]
    before.bkw_gather_floor.argtypes = [vp, vp, vp, ll, ui, vp, vp]
    trace = before.bkw_migrate_traced
    trace.argtypes = [vp, vp, ll, ui, vp, vp, ui, ll, ci, vp, vp, vp, vp, vp]
    for f in (*(getattr(before, e) for e in VARIANTS.values()),
              before.bkw_migrate_round_before, before.bkw_gather_floor,
              trace):
        f.restype = ci

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def probe_with(fn, idx, q):
        found = torch.empty(q.shape[0], dtype=torch.int32, device="cuda")
        rc = fn(idx.keys.data_ptr(), idx.values.data_ptr(), q.data_ptr(),
                q.shape[0], idx.n_shards, idx.capacity, idx.max_probes,
                found.data_ptr(), stream())
        if rc:
            raise RuntimeError(f"probe variant: CUDA error {rc}")
        return found

    probes = {"g4 from the start slot (port)":
              lambda idx, q: idx.probe_device(q)}
    for name, entry in VARIANTS.items():
        probes[name] = lambda idx, q, fn=getattr(before, entry): probe_with(
            fn, idx, q)

    rng = np.random.default_rng(0)
    cap, batch, n_probe = 1 << 23, 1 << 16, 1 << 20
    keys = torch.from_numpy(rng.integers(
        1, 2**32, (3 * cap // 4, 4), dtype=np.uint64).astype(
            np.uint32).view(np.int32)).cuda()
    idx = di.ShardedDedupIndex.create(1, capacity=cap, device="cuda")
    filled = 0
    for load in (0.25, 0.5, 0.75):
        while filled < int(load * cap):
            idx.insert_device(keys[filled:filled + batch],
                              torch.arange(batch, dtype=torch.int32,
                                           device="cuda"))
            filled += batch
        live = int((idx.keys != 0).any(dim=2).sum())
        q = torch.cat([keys[torch.from_numpy(rng.integers(
            0, filled, n_probe // 2)).cuda()], torch.from_numpy(
                rng.integers(1, 2**32, (n_probe // 2, 4), dtype=np.uint64)
                .astype(np.uint32).view(np.int32)).cuda()])
        q = q[torch.from_numpy(rng.permutation(n_probe)).cuda()].contiguous()
        want = di.probe_table_plain(idx.keys, idx.values, q,
                                    max_probes=idx.max_probes)
        for name, fn in probes.items():
            if not torch.equal(fn(idx, q), want):
                raise AssertionError(f"probe {name} disagrees at {load}")
        hit, miss = cs.probe_steps(live / cap)
        bound, _ = cs.bound_ms(16 * n_probe + cs.SECTOR * n_probe / 2
                               * (hit + miss + 1) + 4 * n_probe, 0)
        print(f"load {live / cap:.4f}: every probe bit-exact with the plain "
              f"probe; bound {bound:.4f} ms")
        order = list(probes) + list(probes)[::-1]
        for turn, name in enumerate(order):
            t = cs.queued_ms(torch, lambda: probes[name](idx, q),
                             reps=args.reps)
            print(f"load {live / cap:.4f} turn {turn}: probe {name} "
                  f"{t:.4f} ms per call of 20 queued ({bound / t:.1%} of "
                  f"bound)")
        # yardstick: the random accesses of walks that all end at their
        # first slot
        out = torch.empty(n_probe, dtype=torch.int32, device="cuda")
        t = cs.queued_ms(torch, lambda: before.bkw_gather_floor(
            idx.keys.data_ptr(), idx.values.data_ptr(), q.data_ptr(),
            n_probe, cap, out.data_ptr(), stream()), reps=args.reps)
        print(f"load {live / cap:.4f}: yardstick, a kernel reading every "
              f"query's start-slot key row (16 B) and every other one's "
              f"value (4 B): {t:.4f} ms per call of 20 queued")
    del idx

    small = di.ShardedDedupIndex.create(1, capacity=1 << 21, device="cuda")
    for s0 in range(0, 1 << 20, batch):
        small.insert_device(keys[s0:s0 + batch],
                            torch.arange(batch, dtype=torch.int32,
                                         device="cuda"))
    n_old = 1 << 21
    new_cap = 1 << 23

    def migrate_before(nk, nv, claim):
        """The growth as the port ran it before: rounds until nothing is
        pending, a host read of the flags after each."""
        pending = (small.keys != 0).any(dim=2).reshape(-1).to(torch.uint8)
        gslot = torch.empty(n_old, dtype=torch.int64, device="cuda")
        flags = torch.empty(2, dtype=torch.int32, device="cuda")
        rounds = 0
        while True:
            rc = before.bkw_migrate_round_before(
                small.keys.data_ptr(), small.values.data_ptr(), n_old,
                small.capacity, nk.data_ptr(), nv.data_ptr(), new_cap,
                small.max_probes, pending.data_ptr(), gslot.data_ptr(),
                claim.data_ptr(), flags.data_ptr(), stream())
            if rc:
                raise RuntimeError(f"migration round: CUDA error {rc}")
            rounds += 1
            more, exhausted = flags.tolist()
            if exhausted:
                raise AssertionError("exhausted")
            if not more:
                return rounds

    new = di._empty_table(1, new_cap, torch.device("cuda"))
    old = di._empty_table(1, new_cap, torch.device("cuda"))
    port_ms = cs.migrate_vs_plain(torch, small, new_cap)[:2]
    rounds_before = migrate_before(*old)
    if not (torch.equal(old[0], small.grown(new_cap).keys)):
        raise AssertionError("the migration before disagrees")
    print(f"growth 2^21 -> 2^23 ({int((small.keys != 0).any(dim=2).sum())} "
          f"keys): port one launch of {port_ms[1]} rounds, {port_ms[0]:.4f} "
          f"ms between CUDA events; before {rounds_before} rounds; tables "
          f"bit-identical")
    for turn, name in enumerate(["port", "before", "before", "port"]):
        walls, events = [], []
        for _ in range(args.reps):
            tab = new if name == "port" else old
            tab[0].zero_()
            tab[1].zero_()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            start.record()
            if name == "port":
                di.migrate_round(small.keys, small.values, tab[0], tab[1],
                                 max_probes=small.max_probes,
                                 claim=tab[2]).tolist()
            else:
                migrate_before(*tab)
            end.record()
            end.synchronize()
            walls.append((time.perf_counter() - h0) * 1e3)
            events.append(start.elapsed_time(end))
        print(f"turn {turn}: growth {name}: host wall median "
              f"{statistics.median(walls):.4f} ms (min {min(walls):.4f}, max "
              f"{max(walls):.4f}); CUDA events around it median "
              f"{statistics.median(events):.4f} ms")
    if not torch.equal(new[0], old[0]) or not torch.equal(new[1], old[1]):
        raise AssertionError("the growths disagree")
    for label, tab in (("empty old table", di._empty_table(
            1, 1 << 21, torch.device("cuda"))[:2]),
                       ("load 0.5", (small.keys, small.values))):
        for _ in range(3):
            nk, nv, claim = di._empty_table(1, new_cap, torch.device("cuda"))
            ctl = torch.zeros(8 + 2 * 56, dtype=torch.int32, device="cuda")
            scratch = torch.empty(3 * n_old, dtype=torch.int32,
                                  device="cuda")
            rc = trace(
                tab[0].data_ptr(), tab[1].data_ptr(), n_old, 1 << 21,
                nk.data_ptr(), nv.data_ptr(), new_cap, new_cap,
                small.max_probes, scratch.data_ptr(),
                scratch[n_old:].data_ptr(), claim.data_ptr(),
                ctl.data_ptr(), stream())
            torch.cuda.synchronize()
            rounds = int(ctl[4])
            t = ctl[8:].view(torch.int64)[:2 * rounds + 2].tolist()
            steps = [round((b - a) / 1e3, 1) for a, b in zip(t, t[1:])]
            print(f"migration trace, {label}: {rounds} rounds, us per step "
                  f"(walk+claim, resolve, ...; last: the claim reset) "
                  f"{steps}, total {(t[-1] - t[0]) / 1e3:.1f} us, rc {rc}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    os.chdir(REPO)
    sys.exit(main())
