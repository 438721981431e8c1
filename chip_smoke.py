#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

Phases (each prints its lines and seconds; any failed check exits non-zero):
  1. device: name, count, power limit (nvidia-smi), torch / CUDA / nvcc.
  2. build: every kernel of `bls12_381_torch/kernels/csrc/` with nvcc for
     sm_90a (one process per source, in parallel), with ptxas registers,
     shared memory and spills.
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     card at the main path's shapes, random canonical inputs plus the edge
     values 0, 1 and p-1; exact equality (integers: tolerance none); CUDA
     events around back-to-back calls (the host's issue rate for short
     kernels) and the plain version's time (CUDA events; no yardstick).
  4. main path: the batched pairing at batch 1024 from the repository's
     test vectors ([a]G1, [b]G2, a, b < 1000): lane (1, 1) equals the RELIC
     value, lanes with equal a*b are equal, identity lanes are one, four
     lanes equal the plain path (CPU); launch counts of one pairing (every
     kernel > 0, plan and sqr counts equal to the static schedule); stage
     times and pairings/s on a host clock around synchronized work (median
     of STAGE_REPS runs), and the share of that wall time the host thread
     spent on the CPU issuing the work.
  5. kernel times: each kernel's device time per launch at the shapes of
     phase 3 (torch.profiler); after phase 4, because a profiler session
     may slow the host's launches for the rest of the process.
  6. profile: one pairing under torch.profiler -- device time by kernel
     (device-side events only) and the device's busy share: the union of
     kernel intervals over the unprofiled pairing time.
  7. the `kernels` JSON line, then the device JSON line last.

The script imports nothing of the JAX package.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
VECTORS = ROOT / "tests" / "vectors"
BATCH = 1024
SEED = 20261016
STAGE_REPS = 7                     # host-clock runs per stage; median kept
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
# 32-bit integer multiply-adds per second: 132 SMs x 64 per clock (CUDA C
# Programming Guide throughput table, compute capability 9.0) x 1.98 GHz
IMAD_PER_S = 132 * 64 * 1.98e9


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + json.dumps(kv, default=str), flush=True)


# ---------------------------------------------------------------------------
# Work and bounds per kernel call (per lane; see kernels/mont.py)
# ---------------------------------------------------------------------------


def sop_imads(T: int) -> int:
    """32-bit multiplies of a T-term sum of products: T 12x12 word products
    and the reduction's 12x12 + 12, a wide product counting lo and hi."""
    return 2 * (144 * T + 144) + 12


SQR_IMADS = 2 * (78 + 144) + 12  # 66 off-diagonal + 12 squares, reduction


def bound(n_bytes: float, n_imads: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_imads / IMAD_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------


def time_events(fn, n: int, warm: int = 2) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_events(fn):
    """Run fn once under torch.profiler and return its device-side events
    (kernels, copies) as (name, start_us, end_us): CPU op rows carry their
    kernels' time too, so only rows of device type CUDA are kept."""
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
    # the profiler's records are cyclic garbage; collect them now, or a
    # full collection of them lands inside a later host-clock timing
    del prof
    gc.collect()
    return evs


def busy_us(evs) -> float:
    """Length of the union of the events' device intervals, in us."""
    total, end = 0.0, float("-inf")
    for s, e in sorted((start, end) for _, start, end in evs):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def host_times(fn):
    """STAGE_REPS runs of fn: the wall seconds of each, ending in a
    synchronize, and the host thread's CPU seconds spent issuing it (the
    thread clock may tick coarsely: compare sums, not single runs)."""
    import torch

    wall, cpu = [], []
    for _ in range(STAGE_REPS):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        fn()
        cpu.append(time.thread_time() - c0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    return wall, cpu


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    from bls12_381_torch.kernels import build

    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda,
        nvcc=nvcc.stdout.strip().splitlines()[-1] if nvcc.stdout else None,
        python=sys.version.split()[0])
    print(smi_line, flush=True)
    return smi_line


def phase_build():
    from bls12_381_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build_all()
    say("build", seconds_total=time.perf_counter() - t0, seconds=secs,
        flags=" ".join(build.NVCC_FLAGS))
    for stem in build.SOURCES:
        for line in build.ptxas_report(stem):
            print(f"[build:{stem}] {line}", flush=True)


def rand_fp(shape, gen, device):
    """Random canonical Fp limbs [24, *shape] (top limb < p's top limb)."""
    import torch

    from bls12_381_torch import limbs

    x = torch.randint(0, 1 << 16, (24,) + tuple(shape), generator=gen,
                      device=device, dtype=torch.int32)
    x[23] = torch.randint(0, limbs.FP.p_limbs[23], tuple(shape),
                          generator=gen, device=device, dtype=torch.int32)
    return x


def edge_col(value: int, device):
    import torch

    from bls12_381_torch import params

    return torch.tensor(params.to_limbs(value, 24), dtype=torch.int32,
                        device=device)


def compare(got, ref):
    import torch

    diff = (got.long() - ref.long()).abs()
    lanes = diff.reshape(-1, diff.shape[-1]).amax(0) if diff.dim() > 1 \
        else diff
    return int((lanes != 0).sum()), int(diff.max()) if diff.numel() else 0


def phase_kernels(device):
    """Each kernel against its plain version at the main path's shapes.

    Returns the results and, per shape, the call whose device time
    `phase_kernel_times` reads later: a profiler session may slow the
    host's launches for the rest of the process, so it follows the main
    path's host-clock timings."""
    import torch

    from bls12_381_torch import params
    from bls12_381_torch.kernels import mont, plan_exec as pe

    P = params.P
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    edges = [edge_col(v, device) for v in (0, 1, P - 1)]
    results = {}
    timed = []  # (key, call, kernel name, launches)
    failures = []

    # --- sop: T in {1, 2, 6, 8}, B in {1024, 4 * 68 * 1024}
    for B in (BATCH, 4 * 68 * BATCH):
        for T in (1, 2, 6, 8):
            a = rand_fp((T, B), gen, device).transpose(0, 1).contiguous()
            b = rand_fp((T, B), gen, device).transpose(0, 1).contiguous()
            # lanes 0..2: every operand 0, 1, p-1 (lane 2 with T = 8 is the
            # all-(p-1) carry case)
            for lane, col in enumerate(edges):
                a[:, :, lane], b[:, :, lane] = col, col
            # lane 3: a = 1, b = p - 1; lane 4: a = p - 1, b = 0
            a[:, :, 3], b[:, :, 3] = edges[1], edges[2]
            a[:, :, 4], b[:, :, 4] = edges[2], edges[0]
            got = mont.sop(a, b)
            ref = mont.sop_plain(a, b)
            torch.cuda.synchronize()
            mism, err = compare(got, ref)
            events_ms = time_events(lambda: mont.sop(a, b), n=50)
            plain_ms = time_events(lambda: mont.sop_plain(a, b), n=3, warm=1)
            bms, by = bound(4 * B * 24 * (2 * T + 1), B * sop_imads(T))
            key = f"sop T={T} B={B}"
            results[key] = dict(mismatches=mism, max_abs_err=err,
                                events_ms=events_ms, plain_ms=plain_ms,
                                bound_ms=bms, bound_by=by)
            timed.append((key, lambda a=a, b=b: mont.sop(a, b), "sop_kernel",
                          50))
            say("kernels", kernel=key, **results[key])
            if mism:
                failures.append(key)
            del got, ref

    # --- sqr: G in {1, 3}, B = 1024
    for G in (1, 3):
        a = rand_fp((G, BATCH), gen, device).transpose(0, 1).contiguous()
        for lane, col in enumerate(edges):
            a[:, :, lane] = col
        got = mont.sqr(a)
        ref = mont.sqr_plain(a)
        torch.cuda.synchronize()
        mism, err = compare(got, ref)
        events_ms = time_events(lambda: mont.sqr(a), n=200)
        plain_ms = time_events(lambda: mont.sqr_plain(a), n=5, warm=1)
        bms, by = bound(4 * G * BATCH * 24 * 2, G * BATCH * SQR_IMADS)
        key = f"sqr G={G} B={BATCH}"
        results[key] = dict(mismatches=mism, max_abs_err=err,
                            events_ms=events_ms, plain_ms=plain_ms,
                            bound_ms=bms, bound_by=by)
        timed.append((key, lambda a=a: mont.sqr(a), "sqr_kernel", 200))
        say("kernels", kernel=key, **results[key])
        if mism:
            failures.append(key)

    # --- plan_exec: each main-path plan at B = 1024
    for make_plan in pe.MAIN_PATH_PLANS:
        plan = pe.compile_plan(make_plan())
        ops = rand_fp((plan.n_in, BATCH), gen, device).transpose(0, 1) \
            .contiguous()
        for lane, col in enumerate(edges):
            ops[:, :, lane] = col
        got = pe.plan_exec(ops, plan)
        ref = pe.plan_exec_plain(ops, plan)
        torch.cuda.synchronize()
        mism, err = compare(got, ref)
        events_ms = time_events(lambda: pe.plan_exec(ops, plan), n=20)
        plain_ms = time_events(lambda: pe.plan_exec_plain(ops, plan), n=2,
                               warm=1)
        imads = BATCH * sum(sop_imads(t) for t in plan.sop_terms())
        bms, by = bound(96 * BATCH * (plan.n_in + plan.n_out), imads)
        key = f"plan_exec {plan.name} B={BATCH}"
        results[key] = dict(mismatches=mism, max_abs_err=err,
                            events_ms=events_ms, plain_ms=plain_ms,
                            bound_ms=bms, bound_by=by,
                            nodes=len(plan.instr), groups=len(plan.groups),
                            sop_nodes=len(plan.sop_terms()))
        timed.append((key, lambda ops=ops, plan=plan: pe.plan_exec(ops, plan),
                      "plan_kernel", 20))
        say("kernels", kernel=key, **results[key])
        if mism:
            failures.append(key)
    if failures:
        fail(f"kernel and plain version disagree: {failures}")
    return results, timed


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------


def load_points(a_idx, b_idx):
    """Affine G1 [a]G1 and G2 [b]G2 from the uncompressed test vectors
    (entry i is [i]G; entry 0 the identity)."""
    g1 = (VECTORS / "g1_uncompressed_valid_test_vectors.dat").read_bytes()
    g2 = (VECTORS / "g2_uncompressed_valid_test_vectors.dat").read_bytes()

    def fe(raw):
        return int.from_bytes(raw, "big")

    def g1_at(i):
        e = g1[96 * i: 96 * i + 96]
        if e[0] & 0x40:
            return (0, 0, True)
        return (fe(bytes([e[0] & 0x1F]) + e[1:48]), fe(e[48:96]), False)

    def g2_at(i):
        e = g2[192 * i: 192 * i + 192]
        if e[0] & 0x40:
            return ((0, 0), (0, 0), True)
        x1 = fe(bytes([e[0] & 0x1F]) + e[1:48])
        return ((fe(e[48:96]), x1), (fe(e[144:192]), fe(e[96:144])), False)

    return [g1_at(i) for i in a_idx], [g2_at(i) for i in b_idx]


def encode(ps, qs, device):
    import torch

    from bls12_381_torch.fields import fp, tower as tw

    p_aff = (fp.from_ints([p[0] for p in ps], device=device),
             fp.from_ints([p[1] for p in ps], device=device),
             torch.tensor([p[2] for p in ps], device=device))
    q_aff = (tw.fp2_from_ints([q[0] for q in qs], device=device),
             tw.fp2_from_ints([q[1] for q in qs], device=device),
             torch.tensor([q[2] for q in qs], device=device))
    return p_aff, q_aff


def fp12_rows(f):
    import torch

    return torch.stack([c for c6 in f for c2 in c6 for c in c2])  # [12,L,B]


def take_lanes(aff, lanes, device):
    def t(x):
        return x[..., lanes].to(device) if x.dim() > 1 else \
            x[lanes].to(device)

    x, y, inf = aff
    if isinstance(x, tuple):
        return ((t(x[0]), t(x[1])), (t(y[0]), t(y[1])), t(inf))
    return (t(x), t(y), t(inf))


def expected_launches():
    """Plan and sqr launches of one pairing, from the static schedules."""
    import importlib

    from bls12_381_torch import limbs
    from bls12_381_torch.fields import tower as tw

    pm = importlib.import_module("bls12_381_torch.pairing.pairing")
    k = tw.CYCLO_FUSE
    per_exp_z = sum(n // k + n % k + (1 if mul else 0)
                    for n, mul in pm._X_RUNS)
    # final exp outside the five exp-by-|z|: 10 fp12_mul + 1 fp12_sqr
    plans = 2 * pm.N_COEFFS + 5 * per_exp_z + 11
    # one Fp inversion: pow by p - 2, POW_WINDOW squarings per digit of
    # the field's bit width
    w = limbs.POW_WINDOW
    sqrs = -(-limbs.FP.modulus.bit_length() // w) * w
    return plans, sqrs


def phase_main(device):
    import numpy as np
    import torch

    from bls12_381_torch import limbs
    from bls12_381_torch import pairing as pr
    from bls12_381_torch.fields import tower as tw
    from bls12_381_torch.kernels import LAUNCHES

    rng = np.random.default_rng(SEED)
    a_idx = [int(v) for v in rng.integers(0, 1000, BATCH)]
    b_idx = [int(v) for v in rng.integers(0, 1000, BATCH)]
    fixed = [(1, 1), (0, 5), (7, 0), (0, 0), (2, 3), (3, 2), (6, 1), (1, 6),
             (10, 20), (20, 10), (40, 5)]
    for lane, (a, b) in enumerate(fixed):
        a_idx[lane], b_idx[lane] = a, b
    t0 = time.perf_counter()
    ps, qs = load_points(a_idx, b_idx)
    p_aff, q_aff = encode(ps, qs, device)
    torch.cuda.synchronize()
    say("main", inputs_seconds=time.perf_counter() - t0, batch=BATCH)

    # the main path, counted
    LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # inputs, phase 3's operands
    t0 = time.perf_counter()
    out = pr.pairing(p_aff, q_aff)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated() - held
    plans_exp, sqrs_exp = expected_launches()
    say("main", first_pairing_seconds=first_s, launches=counts,
        expected_plan_exec=plans_exp, expected_sqr=sqrs_exp,
        pairing_peak_bytes=peak, held_bytes=held)
    for name in ("sop", "sqr", "plan_exec"):
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    if counts["plan_exec"] != plans_exp or counts["sqr"] != sqrs_exp:
        fail(f"launch counts {counts} differ from the schedule "
             f"(plan_exec {plans_exp}, sqr {sqrs_exp})")

    # correctness
    rows = fp12_rows(out)  # [12, L, B]
    relic = json.loads((VECTORS / "ref_constants.json").read_text())[
        "relic_pairing_fp12"]
    relic = [int(v, 16) for v in relic]
    lane0 = [int(limbs.to_ints(limbs.FP, rows[i, :, 0])) for i in range(12)]
    if lane0 != relic:
        fail("lane e(G1, G2) differs from the RELIC value")
    one = fp12_rows(tw.fp12_one((1,), device))[..., 0]
    n_ident = 0
    by_product = {}
    for lane, (a, b) in enumerate(zip(a_idx, b_idx)):
        if a == 0 or b == 0:
            n_ident += 1
            if not torch.equal(rows[..., lane], one):
                fail(f"identity lane {lane} is not Fp12 one")
        else:
            by_product.setdefault(a * b, []).append(lane)
    n_groups = 0
    for prod, lanes in by_product.items():
        if len(lanes) > 1:
            n_groups += 1
            ref = rows[..., lanes[0]]
            for lane in lanes[1:]:
                if not torch.equal(rows[..., lane], ref):
                    fail(f"lanes {lanes[0]} and {lane} (a*b = {prod}) differ")
    say("main", relic_lane=True, identity_lanes=n_ident,
        equal_product_groups=n_groups)

    # stage times (host clock around synchronized work, after the warm-up
    # run above; before the CPU-threaded check and the profiler sessions,
    # so that neither can slow the host's launches here)
    prep = pr.prepare_g2(q_aff)
    f = pr.miller_loop_batched(p_aff, prep)
    stages = {
        "prepare_g2": host_times(lambda: pr.prepare_g2(q_aff)),
        "miller_loop_batched": host_times(
            lambda: pr.miller_loop_batched(p_aff, prep)),
        "final_exponentiation": host_times(
            lambda: pr.final_exponentiation(f)),
        "pairing": host_times(lambda: pr.pairing(p_aff, q_aff)),
    }
    med = {k: statistics.median(w) for k, (w, _) in stages.items()}
    say("main", stage_seconds={k: w for k, (w, _) in stages.items()},
        median_seconds=med, pairings_per_s=BATCH / med["pairing"],
        host_cpu_share={k: sum(c) / sum(w)
                        for k, (w, c) in stages.items()})

    check_lanes = [0, 4, BATCH // 2, BATCH - 1]
    t0 = time.perf_counter()
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    cpu_out = pr.pairing(take_lanes(p_aff, check_lanes, "cpu"),
                         take_lanes(q_aff, check_lanes, "cpu"))
    torch.set_num_threads(1)
    plain_s = time.perf_counter() - t0
    if not torch.equal(fp12_rows(cpu_out), rows[..., check_lanes].cpu()):
        fail(f"lanes {check_lanes} differ from the plain path")
    say("main", plain_path_lanes=check_lanes,
        plain_path_cpu_seconds=plain_s, all_checks="passed")
    return counts, med, (p_aff, q_aff)


def phase_kernel_times(results, timed) -> None:
    """Each kernel's device time per launch at the shapes of phase kernels,
    into results[key]["ms"]: the mean duration of its launches as the
    profiler records them on the card.  (CUDA events around back-to-back
    calls time the host's issue rate for kernels that finish faster than
    Python and ctypes can launch them.)  One profiler session runs every
    shape's launches in turn; each kernel's events, in order, are split
    by shape."""
    import torch

    def run_all():
        for _, call, _, n in timed:
            for _ in range(n):
                call()
            torch.cuda.synchronize()

    evs = sorted(device_events(run_all), key=lambda ev: ev[1])
    durs = {}
    for kernel in {t[2] for t in timed}:
        durs[kernel] = [end - start for name, start, end in evs
                        if kernel in name]
        want = sum(n for _, _, k, n in timed if k == kernel)
        if len(durs[kernel]) != want:
            fail(f"profiler recorded {len(durs[kernel])} launches of "
                 f"{kernel}, not {want}")
    for key, _, kernel, n in timed:
        mine, durs[kernel] = durs[kernel][:n], durs[kernel][n:]
        results[key]["ms"] = sum(mine) / n / 1e3
        say("kernel_times", kernel=key, ms=results[key]["ms"],
            events_ms=results[key]["events_ms"],
            bound_ms=results[key]["bound_ms"])


def phase_profile(p_aff, q_aff, pairing_s: float):
    """Where one pairing's time goes on the card: device time by kernel,
    from the profiler's device-side events only, and the device's busy
    share: the union of those events' intervals over the unprofiled
    pairing time (and over the profiled run's device span)."""
    from bls12_381_torch import pairing as pr

    evs = device_events(lambda: pr.pairing(p_aff, q_aff))
    if not evs:
        fail("the profiler recorded no device activity for the pairing")
    by_name = {}
    for name, start, end in evs:
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + end - start, n + 1)
    rows = sorted(((us, n, name) for name, (us, n) in by_name.items()),
                  reverse=True)
    busy_ms = busy_us(evs) / 1e3
    span_ms = (max(e[2] for e in evs) - min(e[1] for e in evs)) / 1e3

    def ours(name):
        return any(k in name for k in ("sop_kernel", "sqr_kernel",
                                       "plan_kernel"))

    say("profile", device_ms=sum(r[0] for r in rows) / 1e3,
        device_busy_ms=busy_ms, pairing_ms=pairing_s * 1e3,
        device_busy_share=busy_ms / (pairing_s * 1e3),
        profiled_span_ms=span_ms, busy_share_of_span=busy_ms / span_ms,
        port_kernels_ms=sum(r[0] for r in rows if ours(r[2])) / 1e3,
        other_device_ms=sum(r[0] for r in rows if not ours(r[2])) / 1e3,
        top=[{"ms": us / 1e3, "count": n, "name": name[:90]}
             for us, n, name in rows[:12]])


def main() -> None:
    t_all = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "bls12_381_torch" / "kernels" / "csrc").is_dir() \
            or not VECTORS.is_dir():
        fail("run from a checkout of the repository (bls12_381_torch/ and "
             "tests/vectors/ next to this script)")
    sys.path.insert(0, str(ROOT))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    t0 = time.perf_counter()
    smi_line = phase_device()
    say("phase", name="device", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_build()
    say("phase", name="build", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    results, timed = phase_kernels(device)
    say("phase", name="kernels", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    counts, med, inputs = phase_main(device)
    say("phase", name="main", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_kernel_times(results, timed)
    del timed
    say("phase", name="kernel_times", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_profile(*inputs, med["pairing"])
    say("phase", name="profile", seconds=time.perf_counter() - t0)

    from bls12_381_torch.kernels import plan_exec as pe

    def entry(name, source, replaces, launches, key):
        r = results[key]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None,
                "shape": key, "mismatches": r["mismatches"]}

    src = "bls12_381_torch/kernels/csrc/"
    kernels = [
        entry("sop", src + "mont.cu",
              "bls12_381_tpu/kernels/pallas_mont.py:620", counts["sop"],
              f"sop T=1 B={4 * 68 * BATCH}"),
        entry("sqr", src + "mont.cu",
              "bls12_381_tpu/kernels/pallas_mont.py:711", counts["sqr"],
              f"sqr G=1 B={BATCH}"),
    ]
    for make_plan in pe.MAIN_PATH_PLANS:
        plan = pe.compile_plan(make_plan())
        kernels.append(entry(
            f"plan_exec:{plan.name}", src + "plan_exec.cu",
            "bls12_381_tpu/kernels/plan_exec.py:778",
            counts["plan_exec_by_plan"].get(plan.name, 0),
            f"plan_exec {plan.name} B={BATCH}"))
    say("phase", name="total", seconds=time.perf_counter() - t_all)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
