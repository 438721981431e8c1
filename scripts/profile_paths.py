#!/usr/bin/env python3
"""Where the port's paths spend device time, to compare two trees on one card.

Run from the root of a checkout on a machine with a CUDA device:

    python3 scripts/profile_paths.py [--reps N]

It imports the `bls12_381_torch` of the tree it sits in and calls only the
entry points (`entry.entry`, `entry.ntt_entry`, `entry.msm_entry`), so a copy
of this file placed in an older tree takes the same measurement there.  For
the pairing at batch 1024, one `ntt` at 2^20, one `msm_g1` at 2^16 points
and one `msm_g2` at 2^12 it prints one JSON line each: the host-clock wall
of one run (median of N after a warm-up, ending in a synchronize), the
device time of one run under torch.profiler (device-side events only), the
device's busy share of the wall, the launches and device ms of the
`CatArrayBatchedCopy` kernels (torch.cat / torch.stack) and of the other
copy kernels, those of the port's kernels by name, and the run's own peak
of allocated device memory above what was held before it.  It imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# substrings of the port's kernel names, in every tree of the port so far
PORT_KERNELS = ("sop_rows_kernel", "sop_kernel", "fold_kernel", "sqr_kernel",
                "plan_kernel", "butterfly_kernel", "pow_kernel")


def device_events(fn):
    """(name, start_us, end_us) of the device-side events of one run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [(ev.name, ev.time_range.start, ev.time_range.end)
           for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    del prof
    gc.collect()
    return evs


def busy_us(evs) -> float:
    """Length of the union of the events' intervals, in us."""
    total, end = 0.0, float("-inf")
    for s, e in sorted((s, e) for _, s, e in evs):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def measure(label: str, fn, reps: int) -> dict:
    import torch

    fn()  # warm-up: builds, constants, plan tables
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = statistics.median(walls) * 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    evs = device_events(fn)

    def total(pick):
        mine = [e - s for name, s, e in evs if pick(name)]
        return {"launches": len(mine), "ms": sum(mine) / 1e3}

    port = {}
    for name, s, e in evs:
        key = next((k for k in PORT_KERNELS if k in name), None)
        if key is not None:
            n, us = port.get(key, (0, 0.0))
            port[key] = (n + 1, us + e - s)
    return {"path": label, "wall_ms": wall_ms, "walls_ms": [w * 1e3
                                                           for w in walls],
            "device_ms": sum(e - s for _, s, e in evs) / 1e3,
            "busy_share": busy_us(evs) / 1e3 / wall_ms,
            "own_peak_bytes": peak,
            "launches": len(evs),
            "cat_copies": total(lambda n: "CatArrayBatchedCopy" in n),
            "other_copies": total(lambda n: "copy" in n.lower()
                                  and "CatArrayBatchedCopy" not in n),
            "port_kernels": {k: {"launches": n, "ms": us / 1e3}
                             for k, (n, us) in sorted(port.items())}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_paths: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from bls12_381_torch import entry

    fn, (p, q) = entry.entry(batch=1024)
    print(json.dumps(measure("pairing B=1024", lambda: fn(p, q),
                             args.reps)), flush=True)
    fn, (x,) = entry.ntt_entry(20)
    print(json.dumps(measure("ntt 2^20", lambda: fn(x), args.reps)),
          flush=True)
    for group, log_n in (("g1", 16), ("g2", 12)):
        fn, (pts, sc) = entry.msm_entry(log_n, group)
        print(json.dumps(measure(f"msm_{group} 2^{log_n}",
                                 lambda: fn(pts, sc), args.reps)),
              flush=True)


if __name__ == "__main__":
    main()
