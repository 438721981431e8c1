#!/usr/bin/env python3
"""Where the port's paths spend device time, to compare two trees on one card.

Run from the root of a checkout on a machine with a CUDA device:

    python3 scripts/profile_paths.py [--reps N] [--rows ROW ...]

It imports the `bls12_381_torch` of the tree it sits in and calls only the
entry points (`entry.entry`, `entry.ntt_entry`, `entry.msm_entry`,
`entry.codec_entry`, `entry.h2c_entry`) and `kernels.mont.fp2_pow_fixed`,
`pow_fixed` and `pow_fixed_fr`, so a copy of this file placed in an older
tree takes the same measurement there.  For the pairing at batch 1024, one
`ntt` at 2^20, one `msm_g1` at 2^16 points, one `msm_g2` at 2^12, the G1
and G2 decompressions of 2^10 points (subgroup check on) and
`hash_to_curve_g1` / `_g2` of 256 messages (the rows that launch the Fp
and Fp2 powers) it prints one JSON line each: the host-clock wall
of one run (median of N after a warm-up, ending in a synchronize), the
device time of one run under torch.profiler (device-side events only), the
device's busy share of the wall, the launches and device ms of the
`CatArrayBatchedCopy` kernels (torch.cat / torch.stack) and of the other
copy kernels, those of the port's kernels by name, and the run's own peak
of allocated device memory above what was held before it.  Row `fp2_pow`
prints the Fp2 power kernel's device ms per launch (the mean of
FP2_POW_LAUNCHES launches in one profiled window) at (p-1)/2 and (p-3)/4
over random canonical operands at FP2_POW_WIDTHS lanes; row `pow` the Fp
power's at p - 2 and the Fr power's at q - 2 (POW_LAUNCHES launches) at
POW_WIDTHS lanes.  `--rows` picks
rows, so that two trees can be compared row by row in one call.  It imports
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
                "plan_kernel", "butterfly_kernel", "fp2_pow_kernel",
                "pow_kernel")
ROWS = ("pairing", "ntt", "msm_g1", "msm_g2", "g1_decompress",
        "g2_decompress", "h2c_g1", "h2c_g2", "fp2_pow", "pow")
FP2_POW_WIDTHS = (1, 256, 512, 1024, 1 << 16)
FP2_POW_LAUNCHES = 20
POW_WIDTHS = (1, 1024, 1 << 16)
POW_LAUNCHES = 10


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


def fp2_pow_rows() -> None:
    """The Fp2 power kernel's device ms per launch, one JSON line per
    exponent and width."""
    import torch

    from bls12_381_torch import limbs, params
    from bls12_381_torch.kernels import mont

    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    for label, e in (("(p-1)/2", (params.P - 1) // 2),
                     ("(p-3)/4", (params.P - 3) // 4)):
        for B in FP2_POW_WIDTHS:
            a = torch.randint(0, 1 << 16, (2, 24, B), generator=gen,
                              device="cuda", dtype=torch.int32)
            a[:, 23] %= limbs.FP.p_limbs[23]  # canonical: below p

            def run():
                for _ in range(FP2_POW_LAUNCHES):
                    mont.fp2_pow_fixed(a[0], a[1], e)

            mont.fp2_pow_fixed(a[0], a[1], e)  # builds, warms
            mine = [end - start for name, start, end in device_events(run)
                    if "pow_kernel" in name]
            print(json.dumps({
                "path": f"fp2_pow_fixed {label} B={B}",
                "launches": len(mine),
                "ms": sum(mine) / len(mine) / 1e3}), flush=True)


def pow_rows() -> None:
    """The Fp and Fr power kernels' device ms per launch, one JSON line per
    field and width."""
    import torch

    from bls12_381_torch import limbs, params
    from bls12_381_torch.kernels import mont

    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    for name, spec, label, e in (
            ("pow_fixed", limbs.FP, "p-2", params.P - 2),
            ("pow_fixed_fr", limbs.FR, "q-2", params.Q - 2)):
        fn = getattr(mont, name)
        for B in POW_WIDTHS:
            n = spec.n_limbs
            a = torch.randint(0, 1 << 16, (n, B), generator=gen,
                              device="cuda", dtype=torch.int32)
            a[n - 1] %= spec.p_limbs[n - 1]  # canonical: below the modulus

            def run():
                for _ in range(POW_LAUNCHES):
                    fn(a, e)

            fn(a, e)  # builds, warms
            for _ in range(3):  # a capture that falls short is taken again
                mine = [end - start for kname, start, end in device_events(
                    run) if "pow_kernel" in kname and "fp2" not in kname]
                if len(mine) == POW_LAUNCHES:
                    break
            print(json.dumps({
                "path": f"{name} {label} B={B}", "launches": len(mine),
                "ms": sum(mine) / len(mine) / 1e3}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rows", nargs="+", choices=ROWS, default=ROWS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_paths: needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from bls12_381_torch import entry

    def row(label, fn, fn_args):
        print(json.dumps(measure(label, lambda: fn(*fn_args), args.reps)),
              flush=True)

    if "pairing" in args.rows:
        row("pairing B=1024", *entry.entry(batch=1024))
    if "ntt" in args.rows:
        row("ntt 2^20", *entry.ntt_entry(20))
    for group, log_n in (("g1", 16), ("g2", 12)):
        if f"msm_{group}" in args.rows:
            row(f"msm_{group} 2^{log_n}", *entry.msm_entry(log_n, group))
    for group in ("g1", "g2"):
        if f"{group}_decompress" in args.rows:
            row(f"{group}.from_compressed_host 2^10",
                *entry.codec_entry(10, group, "compressed"))
    for group in ("g1", "g2"):
        if f"h2c_{group}" in args.rows:
            row(f"hash_to_curve_{group} 256",
                *entry.h2c_entry(8, group, "hash"))
    if "fp2_pow" in args.rows:
        fp2_pow_rows()
    if "pow" in args.rows:
        pow_rows()


if __name__ == "__main__":
    main()
