#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's kernels alone on one NVIDIA card: the rows
of the kernel table in PERF.md section 6.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

The card's correctness checks are the `gpu` tests
(`python3 -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_*_gpu.py`); the paths' end-to-end numbers come from
`portbench/run.py`.  This script times each kernel alone.  Phases (each
prints its lines and seconds; a failure exits non-zero):
  1. device: name, count, power limit (nvidia-smi), torch, the CUDA driver
     and toolkit versions (the row kernel's largest parameter block needs
     12.1 in both), nvcc.
  2. build: every kernel of `bls12_381_torch/kernels/csrc/` with nvcc for
     sm_90a (one process per source, in parallel), with ptxas registers,
     shared memory and spills (the plan, power and row kernels' also as
     JSON, the row kernel per field and parameter capacity).
  3. kernels: each kernel at the paths' shapes, random canonical operands
     with the edge values 0, 1, p-1 (and q-2 for Fr): the row kernel
     (`sop_rows`, behind `sop`, `fold_planned` and `sop_fr`) at T = 1, 2,
     6, 8, uneven folds, the operand layouts it reads in place and the
     calls of one pairing (its folds and its norm), one msm_g1 (its
     products), one ntt (its twiddle doublings) and one call of each
     scalar multiplication row at its width (by route), recorded with their
     operands' strides (`record_rows`) and replayed, on the shapes that
     pick the launch shape the chosen shape beside split = 1 and a 32-lane
     tile; every plan at one lane, a ragged last tile and batch 1024, the
     group-law plans also at the MSM's widths; the plan kernel's fold mode
     over an MSM's bucket lanes at 2^20 points and at a blob (its first
     level, and every level); `sqr`, `pow_fixed`,
     `pow_fixed_fr` and `fp2_pow_fixed` at their paths' exponents and
     widths; the butterfly.  Each row is equal to its plain version (on
     sampled lanes where the plain version cannot run at the width), with
     its launch shape, registers and spills, CUDA events around
     back-to-back calls (the host's issue rate for short kernels), its
     bound (`bound`: bytes over HBM_BYTES_PER_S, 32-bit multiplies over
     IMAD_PER_S) and the plain version's time (CUDA events; no yardstick).
     The rows bound by bytes are timed over copies of their operands taken
     in turn, more than twice the L2 in all (`rotating`), so that each
     launch reads from HBM.  The launches of the pairing, ntt, msm_g1,
     msm_g2 and scalar multiplication calls are counted on the way.
  3b. hashes: the XMD (32 bytes to 256 under a 10-byte DST), the SHA-256
     digest of 32 bytes and the SHAKE-128 XOF of the XMD's shape at 256
     and 2^16 lanes and at one lane (the chain), each beside its bounds by
     operations and by bytes and the plain version's time.
  3c. counts: the launches of one call of the paths whose row-kernel
     calls are not replayed: the BLS round trip through the public
     functions, each codec and hash to curve row, msm_g1_large at 2^20 and
     2^24, the device calls the card tests hold to the host oracle, and
     each sharded path on one and on four ranks.
  4. kernel times: each row's device time per launch (torch.profiler,
     device-side events), one session over every row's launches.
  5. the `kernels` JSON line (each kernel's row, with its launches per
     counted path as `launches_<path>`), then the device line last.

The script imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import gc
import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the seed, widths and case lists the timer shares with the card tests
sys.path.append(str(ROOT / "tests"))
try:
    from port_cases import (
        BATCH, CODEC_FORMS, FP2_EDGE_LANES, H2C_LOG_N, H2C_ROWS, HASH_DST,
        NOT_ROWS, PARALLEL_RANKS, PARALLEL_WINDOW, SEED, SMUL_ROWS,
        SQR_WIDTHS, bls_round_trip, encode, oracle_inputs, pairing_inputs,
        parallel_job, spawn_ranks, to_cpu)
except ImportError:
    sys.exit("chip_smoke.py: run from a checkout of the repository "
             "(tests/port_cases.py next to this script)")
NTT_LOG_N = 20                     # bench.py's scalar NTT 2^20
NTT_N = 1 << NTT_LOG_N
DOUBLINGS = f"sop_fr twiddle doublings of one ntt at 2^{NTT_LOG_N}"
PAIRING_FOLDS = f"fold_planned folds of one pairing, batch {BATCH}"
PAIRING_NORM = f"sop norm of one pairing, batch {BATCH}"
MSM_LOG_N = {"g1": 16, "g2": 12}   # a 2^16 KZG commitment; 4096 signatures
FOLD_LOG_N = (20, 12)  # the bucket fold at the MSM cells' 2^20 points, a blob
PLAN_RAGGED = 1021                 # 255 tiles of 4 lanes and one of 1
# the widest launches of one default chunk of msm_g1_large (2^21 points,
# 2^22 GLV lanes): the scans' g1_add at 2^21 lanes (2^22 at chunk 22),
# to_affine's products at 2^21; held to the plain versions on sampled lanes
MSM_LARGE_PLAN_WIDTHS = (1 << 21, 1 << 22)
MSM_LARGE_SOP_WIDTH = 1 << 21
SAMPLED_LANES = 1024               # per sample: first, last, random lanes
MSM_SOPS = f"sop products of one msm_g1 at 2^{MSM_LOG_N['g1']}"
# the Fp2 square root's exponents (p-3)/4 and (p-1)/2 (tower.fp2_sqrt)
# beside 0, 1 and 2
FP2_POW_EXPONENTS = ("(p-3)/4", "(p-1)/2", "0", "1", "2")
FP2_POW_TIMED = ("(p-3)/4", "(p-1)/2")
# the codecs' 2^10 lanes, a partial block, h2c's 2 x 256 and 256 lanes
# (the round trip's too), a pair of warps of which one lane is live, one
# lane; and the card full, held on sampled lanes
FP2_POW_WIDTHS = (1024, 1021, 512, 256, 33, 1)
FP2_POW_WIDE = 1 << 16
FP2_POW_TIMED_WIDTHS = (1, 256, 512, 1024, FP2_POW_WIDE)
FP2_POW_LANE_BYTES = 16 * 2 * 12 * 4  # window table per lane (fp2_pow.cuh)
# pow_fixed / pow_fixed_fr (mont_pow.cuh): the inversions' and square
# roots' exponents (Fr's (t-1)/2: fr.sqrt) beside 1, 2 and 16; one lane, a
# partial block, a partial last warp, the paths' 1024; the widths where the
# launch takes 2 (Fp) and 1 threads a lane, held on sampled lanes; the
# inversions timed at 1, 1024 and 2^16
POW_EXPONENTS = {"pow_fixed": ("p-2", "(p+1)/4", "(p-1)/2", "1", "2", "16"),
                 "pow_fixed_fr": ("q-2", "(t-1)/2")}
POW_TIMED = ("p-2", "q-2")
POW_WIDTHS = (1024, 1021, 33, 1)
POW_WIDE = 1 << 16
POW_SAMPLED = (1 << 13, POW_WIDE)  # slices of the POW_WIDE operand
POW_TIMED_WIDTHS = (1, 1024, POW_WIDE)
# sqr (mont_sqr.cuh) at SQR_WIDTHS, timed at G = 1 from HBM; 24 bytes of
# parameters (two pointers, G, B)
SQR_TIMED_WIDTHS = (1024, 1 << 16, 1 << 20)
SQR_PARAM_BYTES = 24
SMUL_PLAN_WIDTH = 1 << 12  # the widest group-law launches of SMUL_ROWS
HASH_TIMED_WIDTHS = (256, 1 << 16)  # hash to curve's rows; the card full
# the paths counted but not replayed (phase counts): the BLS round trip's
# lanes, the codec rows' lanes, msm_g1_large's window at 2^20 and 2^24, the
# G2 points of psi
BLS_LOG_N = 8
CODEC_LOG_N = 10
MSM_LARGE_C = 13
MSM_LARGE_LOG_NS = (20, 24)
PSI_LOG_N = 8


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + json.dumps(kv, default=str), flush=True)


# ---------------------------------------------------------------------------
# Work and bounds per kernel call (per lane; see kernels/mont.py)
# ---------------------------------------------------------------------------


def sop_imads(T: int, words: int = 12) -> int:
    """32-bit multiplies of a T-term sum of products over `words` 32-bit
    words (12 for Fp, 8 for Fr): T word products and the reduction's
    words^2 + words, a wide product counting lo and hi."""
    return 2 * words * words * (T + 1) + words


def sqr_imads(words: int = 12) -> int:
    """32-bit multiplies of a square (mont_sqr.cuh's sqr_words): the
    words (words - 1) / 2
    off-diagonal and `words` diagonal word products, then the reduction."""
    return 2 * (words * (words + 1) // 2 + words * words) + words


BUTTERFLY_IMADS = sop_imads(1, 8)  # one Fr product; the add/sub are IADDs
BUTTERFLY_BYTES = 4 * 16 * 5       # a, b, w read; lo, hi written (int32)

# 32-bit instructions the hash kernels need at least, counted from
# csrc/sha256.cu and csrc/keccak.cu as sm_90 issues them: one LOP3 for any
# boolean function of up to three inputs, one IADD3 for an add of up to
# three, one funnel shift (SHF) for a 32-bit rotation or shift and two for
# a 64-bit rotation.  A SHA-256 compression: 48 schedule words (each sigma
# two rotations, a shift and a LOP3; the four-term add two IADD3) and 64
# rounds (S1 and S0 three rotations and a LOP3 each; ch and maj a LOP3
# each; t1's five terms two IADD3, e one add, a one IADD3), then eight
# adds.  A Keccak-f[1600] permutation: 24 rounds of 180 on the two 32-bit
# halves of each lane (theta: the five-way column xors 2 x 2 x 5, the
# rotations of D 2 x 5, a ^= C[x-1] ^ rot(C[x+1]) one LOP3 a half, 50;
# rho 24 rotations, 48; chi one LOP3 a half, 50; iota 2).
SHA256_COMPRESSION_OPS = (48 * (4 + 4 + 2) + 64 * (4 + 1 + 2 + 4 + 1 + 1 + 1)
                          + 8)
KECCAK_F_OPS = 24 * (20 + 10 + 50 + 48 + 50 + 2)


def sha256_blocks(n_bytes: int) -> int:
    """Compressions of the SHA-256 of n_bytes (the padding adds 9 bytes
    at least)."""
    return -(-(n_bytes + 9) // 64)


def xmd_work(B: int, msg_len: int, len_in_bytes: int, dst_len: int):
    """(bytes, 32-bit operations) of one expand_message_xmd launch over B
    lanes: each message read once and each output written once; b0's
    blocks after the Z_pad midstate (the host's, once per call) and ell
    b_i of (b0 ^ b_(i-1)) || i || DST' each."""
    dst_prime = (32 if dst_len > 255 else dst_len) + 1
    ell = -(-len_in_bytes // 32)
    blocks = (sha256_blocks(64 + msg_len + 3 + dst_prime) - 1
              + ell * sha256_blocks(33 + dst_prime))
    return (B * (msg_len + len_in_bytes),
            B * blocks * SHA256_COMPRESSION_OPS)


def shake_work(B: int, n_absorbed: int, msg_len: int, out_len: int,
               rate: int):
    """(bytes, 32-bit operations) of one SHAKE launch over B lanes whose
    sponge absorbs n_absorbed bytes a lane (the message and any suffix)
    and squeezes out_len: the permutations after each absorbed block and
    between squeezed ones."""
    perms = n_absorbed // rate + 1 + (-(-out_len // rate) - 1)
    return B * (msg_len + out_len), B * perms * KECCAK_F_OPS


def pow_chain(exponent: int, modulus: int):
    """(squares, products) one lane of the power kernel runs for this
    exponent: the window table's 14 products, then after the leading
    nonzero digit 4 squares per digit and a product per nonzero digit."""
    from bls12_381_torch.kernels import mont

    digits = [int(d) for d in mont.pow_digits(exponent, modulus)]
    rest = digits[next((i for i, d in enumerate(digits) if d), len(digits)):]
    rest = rest[1:]
    return 4 * len(rest), 14 + sum(1 for d in rest if d)


def pow_work(spec, exponent: int, B: int):
    """(bytes, 32-bit multiplies) of one power launch over B lanes: the
    operand read and the result written once (int32 limbs); squares by
    the sqr kernel's body."""
    words = spec.n_limbs // 2
    squares, products = pow_chain(exponent, spec.modulus)
    return (4 * spec.n_limbs * 2 * B,
            B * (squares * sqr_imads(words)
                 + products * sop_imads(1, words)))


def fp2_pow_work(exponent: int, B: int):
    """(bytes, 32-bit multiplies) of one Fp2 power launch over B lanes: a0,
    a1 read and c0, c1 written once (int32 limbs); pow_chain's schedule of
    Fp2 squares, each two one-term Fp products (sop_imads(1)), and Fp2
    products at their least work, Karatsuba's three word products with two
    reductions (the kernel does four): 3 x 2 W^2 + 2 (2 W^2 + W)."""
    from bls12_381_torch import params

    W = 12
    squares, products = pow_chain(exponent, params.P)
    fp2_product = 3 * 2 * W * W + 2 * (2 * W * W + W)
    return (4 * 24 * 4 * B,
            B * (2 * squares * sop_imads(1) + products * fp2_product))


# one H100 SXM at its full power limit: HBM3 bytes per second, and 32-bit
# integer multiply-adds per second, 132 SMs x 64 per clock (CUDA C
# Programming Guide throughput table, compute capability 9.0) x 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9


def bound(n_bytes: float, n_imads: float):
    """(least ms, what bounds it) on one H100: bytes over HBM_BYTES_PER_S,
    32-bit multiplies over IMAD_PER_S."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_imads / IMAD_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------

L2_BYTES = 50 << 20                # the H100's L2


def rotating(fn, *operands):
    """(call, copies): a call of fn that takes the next of `copies` copies
    of its operands each time, enough copies that they hold more than twice
    the card's L2.  Launched back to back, each call then reads operands
    the L2 no longer holds, from HBM, as a path's call on fresh data does;
    over one set of operands a kernel whose operands fit in the L2 would
    read them from there and time under its bound by bytes."""
    size = sum(t.untyped_storage().nbytes() for t in operands)
    copies = -(-(2 * L2_BYTES + 1) // size)
    sets = [operands] + [tuple(t.clone() for t in operands)
                         for _ in range(copies - 1)]
    turn = itertools.cycle(sets)
    return (lambda: fn(*next(turn))), copies


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
    (kernels, copies) as (name, start_us, end_us).  Only device activity
    is traced: tracing the host's torch ops too gives the same device events
    and takes several times as long on the h2c rows' tens of thousands of
    ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a marker kernel first, finished before fn starts: profiles of the
        # smul rows lost the first kernel of fn (their Fr conversion), and
        # the marker's own event is dropped below
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    evs = [(ev.name, ev.time_range.start, ev.time_range.end)
           for ev in prof.events() if ev.device_type == DeviceType.CUDA
           and "spin_kernel" not in ev.name]
    # the profiler's records are cyclic garbage; collect them now, or a
    # full collection of them lands inside a later host-clock timing
    del prof
    gc.collect()
    return evs


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
    toolkit = re.search(r"release (\d+)\.(\d+)", nvcc.stdout)
    toolkit = (int(toolkit[1]), int(toolkit[2])) if toolkit else None
    # the driver's CUDA version, from the driver library itself
    version = ctypes.c_int(0)
    ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(version))
    driver = (version.value // 1000, version.value % 1000 // 10)
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda,
        nvcc=nvcc.stdout.strip().splitlines()[-1] if nvcc.stdout else None,
        driver_cuda=driver, toolkit_cuda=toolkit,
        # the row kernel's largest capacity (27 KB of parameters) needs 12.1
        # in both
        params_over_4kb=bool(toolkit and min(driver, toolkit) >= (12, 1)),
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
    usage = {"plan_exec": ptxas_usage("plan_exec", "plan_kernelILb0E"),
             "plan_exec fold": ptxas_usage("plan_exec", "plan_kernelILb1E"),
             # the power's instances by threads per lane (the launch
             # picks one by the width: mont.pow_threads_per_lane)
             **{f"pow_fixed t{t}": ptxas_usage(
                 "mont", "15mont_pow_kernel", f"ELi{t}ELi32E")
                for t in (4, 2, 1)},
             **{f"pow_fixed_fr t{t}": ptxas_usage(
                 "fr", "15mont_pow_kernel", f"ELi{t}ELi32E")
                for t in (2, 1)},
             "fp2_pow_fixed": ptxas_usage("mont", "fp2_pow_kernel"),
             "sqr": ptxas_usage("mont", "7montsqr10sqr_kernel"),
             # the XMD's instances by message load width; the main path's
             # 32-byte rows take 16
             "xmd_sha256": ptxas_usage("sha256", "17xmd_sha256_kernelILi16E"),
             "xmd_sha256 load4": ptxas_usage("sha256",
                                             "17xmd_sha256_kernelILi4E"),
             "xmd_sha256 load1": ptxas_usage("sha256",
                                             "17xmd_sha256_kernelILi1E"),
             "sha256": ptxas_usage("sha256", "13sha256_kernel"),
             "shake": ptxas_usage("keccak", "12shake_kernel")}
    for suffix, stem in (("", "mont"), ("_fr", "fr")):
        for r, e in ROW_CAPS:
            usage[f"sop_rows{suffix} {r}x{e}"] = ptxas_usage(
                stem, "sop_rows_kernel", f"SopRowsArgsILi{r}ELi{e}E")
    say("build", registers_and_spill_bytes=usage)
    return usage


def ptxas_usage(stem: str, *parts: str):
    """(registers, spill store + load bytes) of the kernel whose mangled
    name holds every one of `parts`, from `ptxas -v`'s lines in its
    library's build log."""
    from bls12_381_torch.kernels import build

    regs = spills = None
    mine = False
    for line in build.ptxas_report(stem):
        if "Compiling entry" in line:
            mine = all(part in line for part in parts)
        elif mine and (m := re.search(r"Used (\d+) registers", line)):
            regs = int(m[1])
        elif mine and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            spills = int(m[1]) + int(m[2])
    return regs, spills


def rand_fp(shape, gen, device):
    """Random canonical Fp limbs [24, *shape] (top limb < p's top limb)."""
    import torch

    from bls12_381_torch import limbs

    x = torch.randint(0, 1 << 16, (24,) + tuple(shape), generator=gen,
                      device=device, dtype=torch.int32)
    x[23] = torch.randint(0, limbs.FP.p_limbs[23], tuple(shape),
                          generator=gen, device=device, dtype=torch.int32)
    return x


def rand_fr(shape, gen, device):
    """Random canonical Fr limbs [16, *shape]: the top limb masked to 14
    bits, values < 2^254 < q (the NTT inputs' distribution)."""
    import torch

    x = torch.randint(0, 1 << 16, (16,) + tuple(shape), generator=gen,
                      device=device, dtype=torch.int32)
    x[15] &= 0x3FFF
    return x


def edge_col(value: int, device, n_limbs: int = 24):
    import torch

    from bls12_381_torch import params

    return torch.tensor(params.to_limbs(value, n_limbs), dtype=torch.int32,
                        device=device)


def pow_operand(spec, B: int, gen, device):
    """Random canonical limbs [L, B] of the field; lanes 1..6 hold 0, 1, 2,
    m-1, m-2 and R mod m, as many as B has room for."""
    m, L = spec.modulus, spec.n_limbs
    x = (rand_fp if L == 24 else rand_fr)((B,), gen, device)
    edges = (0, 1, 2, m - 1, m - 2, (1 << (16 * L)) % m)
    for lane, v in enumerate(edges[:max(B - 1, 0)]):
        x[:, lane + 1] = edge_col(v, device, L)
    return x


def fp2_pow_operand(B: int, gen, device):
    """Random canonical (a0, a1) [24, B]; lanes 0..8 hold FP2_EDGE_LANES
    (0 as 0, 1 as 1, p-1 as p - 1, R as R mod p), as many as B holds."""
    from bls12_381_torch.params import P

    value = {"0": 0, "1": 1, "p-1": P - 1, "R": (1 << 384) % P}
    a0, a1 = rand_fp((B,), gen, device), rand_fp((B,), gen, device)
    for lane, (x, y) in enumerate(FP2_EDGE_LANES[:B]):
        a0[:, lane] = edge_col(value[x], device)
        a1[:, lane] = edge_col(value[y], device)
    return a0, a1


def plan_edge_lanes(ops, P: int) -> None:
    """Lanes 0..3 of a plan's operands [K, 24, B], as many as B holds: every
    row p-1, every row 0, rows cycling 0, 1, p-1, every row 1."""
    rows = ops.shape[0]
    cols = {v: edge_col(v, ops.device) for v in (0, 1, P - 1)}
    lanes = ([P - 1] * rows, [0] * rows,
             [(0, 1, P - 1)[k % 3] for k in range(rows)], [1] * rows)
    for lane, values in enumerate(lanes[:ops.shape[2]]):
        for k, v in enumerate(values):
            ops[k, :, lane] = cols[v]


def compare(got, ref):
    import torch

    diff = (got.long() - ref.long()).abs()
    lanes = diff.reshape(-1, diff.shape[-1]).amax(0) if diff.dim() > 1 \
        else diff
    return int((lanes != 0).sum()), int(diff.max()) if diff.numel() else 0


# The port's kernels as the profiler names them on the card: the substrings
# each name holds.  One row-kernel template serves both fields: its Fp
# launches are the `sop` and `fold_planned` counts, its Fr ones `sop_fr`.
KERNEL_NAMES = {"sop_rows": ("sop_rows_kernel", "fp384"),
                "sqr": ("sqr_kernel",),
                "plan_exec": ("plan_kernel",),
                "sop_rows_fr": ("sop_rows_kernel", "fr256"),
                "butterfly": ("butterfly_kernel",),
                "pow_fixed": ("mont_pow_kernel", "fp384"),
                "pow_fixed_fr": ("mont_pow_kernel", "fr256"),
                "fp2_pow_fixed": ("fp2_pow_kernel",),
                "xmd_sha256": ("xmd_sha256_kernel",),
                "sha256": ("::sha256_kernel",),
                "shake": ("shake_kernel",)}
ROW_CAPS = ((16, 16), (64, 128), (1024, 512))  # montgomery.cuh SOP_ROWS_CAPS


def kernel_of(name: str):
    """The port kernel a device-side event belongs to, or None."""
    return next((k for k, subs in KERNEL_NAMES.items()
                 if all(sub in name for sub in subs)), None)


FOLD_CASES = (
    (4, 1, 68 * BATCH, [[(1, 5)], [(2, 5)], [(3, 6)], [(4, 6)]]),
    (8, 2, 1 << 16, [[(1, 3), (2, 4)], [(1, 4), (2, 3)], [(5, 7), (6, 8)],
                     [(5, 8), (6, 7)], [(1, 7), (2, 8)], [(1, 8), (2, 7)],
                     [(5, 3), (6, 4)], [(5, 4), (6, 3)]]),
    (4, 6, 1 << 16, [[(9, 9)] * 6, [(1, 2)], [(3, 4), (4, 3), (1, 1)],
                     [(2, 5), (6, 7), (8, 1), (3, 3), (4, 4)]]),
)


def fold_bytes(B: int, groups) -> int:
    """Bytes a planned fold must move: each stack row that a term names
    read once (padding terms name the zero row and read nothing), each of
    the G outputs written once."""
    rows = {i for g in groups for pair in g for i in pair}
    return 4 * B * 24 * (len(rows) + len(groups))


def distinct_elements(x) -> int:
    """Elements of a tensor's own data: an axis of stride 0 (a broadcast)
    counts once."""
    n = 1
    for size, stride in zip(x.shape, x.stride()):
        n *= size if stride else 1
    return n


def rows_work(call):
    """(bytes, 32-bit multiplies) a `sop_rows` call must do: each row its
    terms name read once, as the row's own elements, each of the G outputs
    written once; a T-term group's products and one reduction per lane."""
    spec, rows, ia, ib, counts, batch = call
    B = 1
    for d in batch:
        B *= d
    named = {int(t[g, i]) for t in (ia, ib) for g, n in enumerate(counts)
             for i in range(int(n))}
    words = spec.n_limbs // 2
    return (4 * (sum(distinct_elements(rows[k]) for k in named)
                 + len(counts) * spec.n_limbs * B),
            B * sum(sop_imads(int(n), words) for n in counts))


def rows_launch(call, n_sm: int, usage, shape=None) -> dict:
    """The launch of one `sop_rows` call: lane tile, group slots per
    block, threads per group, blocks, threads per block, parameter bytes
    (the kernel's own sizeof) and the capacity's registers and spills."""
    from bls12_381_torch.kernels import mont

    spec, rows, ia, ib, counts, batch = call
    G, T = ia.shape
    B = 1
    for d in batch:
        B *= d
    lt, gpb, split = shape or mont.sop_launch_shape(G, T, B, n_sm)
    r, e = next(c for c in ROW_CAPS if len(rows) <= c[0] and G * T <= c[1])
    regs, spills = usage[f"sop_rows{'_fr' if spec.n_limbs == 16 else ''} "
                         f"{r}x{e}"]
    return {"lane_tile": lt, "group_slots": gpb, "threads_per_group": split,
            "blocks": -(-B // lt), "threads": lt * gpb * split,
            "param_bytes": mont.sop_rows_param_bytes(len(rows), G * T),
            "registers": regs, "spill_bytes": spills}


def record_rows(fn):
    """Run fn once and return the calls it makes of `mont.sop_rows`:
    (spec, rows, ia, ib, counts, batch), each row a copy of its storage
    seen through the row's own size, strides and offset, so that a replay
    reads the layouts the path gave the kernel."""
    import numpy as np
    import torch

    from bls12_381_torch.kernels import mont

    calls, real = [], mont.sop_rows

    def spy(spec, rows, ia, ib, counts, batch, shape=None):
        copies = {}  # storages of this call's rows, each copied once

        def keep(x):
            st = x.untyped_storage()
            c = copies.get(st.data_ptr())
            if c is None:
                c = copies[st.data_ptr()] = st.clone()
            return torch.empty(0, dtype=x.dtype, device=x.device).set_(
                c, x.storage_offset(), x.size(), x.stride())

        calls.append((spec, [keep(x) for x in rows], np.array(ia),
                      np.array(ib), np.array(counts), tuple(batch)))
        return real(spec, rows, ia, ib, counts, batch, shape)

    mont.sop_rows = spy
    try:
        fn()
    finally:
        mont.sop_rows = real
    return calls


def counted(paths: dict, label: str, fn):
    """fn(), with its launch counts kept in paths[label]."""
    from bls12_381_torch.kernels import LAUNCHES

    LAUNCHES.reset()
    out = fn()
    paths[label] = LAUNCHES.snapshot()
    return out


def recorded(paths: dict, label: str, fn):
    """`record_rows(fn)`, with fn's launch counts kept in paths[label]."""
    return counted(paths, label, lambda: record_rows(fn))


def fold_tables(groups):
    """[G, T] int32 index tables of groups of (ia, ib) pairs, short groups
    padded with row 0."""
    import numpy as np

    t = max(len(g) for g in groups)
    ia = np.zeros((len(groups), t), np.int32)
    ib = np.zeros((len(groups), t), np.int32)
    for gi, g in enumerate(groups):
        for ti, (a, b) in enumerate(g):
            ia[gi, ti], ib[gi, ti] = a, b
    return ia, ib


def msm_plan_shapes():
    from bls12_381_torch.kernels import plan_exec as pe

    n1, n2 = (1 << MSM_LOG_N[g] for g in ("g1", "g2"))
    return ((pe.g1_add_plan, n1), (pe.g1_double_plan, 1),
            (pe.g2_add_plan, 2 * n2), (pe.g2_double_plan, 1),
            (pe.g1_add_mixed_plan, BATCH), (pe.g2_add_mixed_plan, BATCH))


class KernelChecks:
    """Results of phase kernels: each kernel call held against its plain
    version, timed with CUDA events, with its bound, every time and bound
    per launch; and per shape the call whose device time
    `phase_kernel_times` reads later."""

    def __init__(self):
        self.results, self.timed, self.failures = {}, [], []

    def hold(self, key, call, plain, kernel, n_events, n_plain, n_bytes,
             n_imads, launches=1, ref=None, pick=None, **extra):
        """`launches`: the kernel launches one call makes; n_bytes and
        n_imads are the call's; `ref`: plain()'s value where the caller
        has it already; n_plain = 0 leaves the plain version untimed;
        `pick`: compare only these lanes of the call's value (last axis),
        where plain() computes them alone (`sample_lanes`)."""
        import torch

        got = call()
        if pick is not None:
            got = got.index_select(-1, pick)
        ref = plain() if ref is None else ref
        torch.cuda.synchronize()
        mism, err = compare(got, ref)
        del got, ref
        bms, by = bound(n_bytes, n_imads)
        plain_ms = time_events(plain, n=n_plain, warm=1) / launches \
            if n_plain else None
        self.results[key] = dict(
            mismatches=mism, max_abs_err=err,
            events_ms=time_events(call, n=n_events) / launches,
            plain_ms=plain_ms, bound_ms=bms / launches, bound_by=by, **extra)
        self.timed.append((key, call, kernel, n_events, launches))
        say("kernels", kernel=key, **self.results[key])
        if mism:
            self.failures.append(key)


def sample_lanes(B: int, gen, device):
    """Sorted lanes of a batch of B at which a kernel is held to its plain
    version where that cannot run at the full width (the plain product's
    int64 [24, 24, B] partial products): the first and the last
    SAMPLED_LANES and SAMPLED_LANES random ones."""
    import torch

    rand = torch.randint(0, B, (SAMPLED_LANES,), generator=gen,
                         device=device)
    return torch.unique(torch.cat([
        torch.arange(SAMPLED_LANES, device=device), rand,
        torch.arange(B - SAMPLED_LANES, B, device=device)]))


def exponent(label: str) -> int:
    """The power kernels' exponents by label (Fr's t: q - 1 = 2^s t)."""
    from bls12_381_torch.params import FR_S, P, Q

    t = (Q - 1) >> FR_S
    return {"p-2": P - 2, "(p+1)/4": (P + 1) // 4, "(p-1)/2": (P - 1) // 2,
            "(p-3)/4": (P - 3) // 4, "q-2": Q - 2, "(t-1)/2": (t - 1) // 2,
            "0": 0, "1": 1, "2": 2, "16": 16}[label]


def pow_rows(chk, usage, gen, device) -> None:
    """Phase kernels' rows of `pow_fixed` and `pow_fixed_fr` into `chk`
    (KernelChecks; `usage`: ptxas registers and spill bytes by kernel, the
    power's by threads per lane, which each row prints with the launch's):
    POW_EXPONENTS at POW_WIDTHS over pow_operand's edge lanes, one plain
    call per exponent at 1024 lanes whose first lanes (lane 9, random, for
    B = 1) hold the narrower launches, and at POW_SAMPLED, the first B
    lanes of a POW_WIDE operand, held on its sampled lanes below B; the
    plain version timed once per field, at 1024 lanes
    (1-2 s a call on the card).  The inversions timed at
    POW_TIMED_WIDTHS."""
    from bls12_381_torch import limbs
    from bls12_381_torch.kernels import mont

    n = mont.POW_LANES
    for wrapper, labels in POW_EXPONENTS.items():
        spec = limbs.FP if wrapper == "pow_fixed" else limbs.FR
        fn = getattr(mont, wrapper)
        a = pow_operand(spec, BATCH, gen, device)
        wide = pow_operand(spec, POW_WIDE, gen, device)
        pick = sample_lanes(POW_WIDE, gen, device)
        for label in labels:
            e = exponent(label)
            ref = mont.pow_fixed_plain(spec, a, e)
            ref_wide = mont.pow_fixed_plain(spec, wide.index_select(1, pick),
                                            e)
            for B in POW_WIDTHS + POW_SAMPLED:
                if B in POW_SAMPLED:
                    below = pick < B
                    x, want, lanes_held = wide[:, :B].contiguous(), \
                        ref_wide[:, below], pick[below]
                else:
                    held = slice(0, B) if B > 1 else slice(9, 10)
                    x, want, lanes_held = a[:, held].contiguous(), \
                        ref[:, held], None
                timed = label in POW_TIMED and B in POW_TIMED_WIDTHS
                n_bytes, n_imads = pow_work(spec, e, B)
                tpi = mont.pow_threads_per_lane(spec, B)
                regs, spills = usage[f"{wrapper} t{tpi}"]
                chk.hold(f"{wrapper} {label} B={B}",
                         lambda fn=fn, x=x, e=e: fn(x, e),
                         lambda spec=spec, x=x, e=e: mont.pow_fixed_plain(
                             spec, x, e),
                         wrapper, 20 if timed else 2,
                         1 if timed and B == BATCH else 0, n_bytes, n_imads,
                         ref=want, pick=lanes_held, threads_per_lane=tpi,
                         lanes=n, blocks=-(-B // n),
                         shared_bytes=16 * spec.n_limbs * 2 * n,
                         registers=regs, spill_bytes=spills,
                         bytes_ms=bound(n_bytes, 0)[0],
                         ops_ms=bound(0, n_imads)[0])
            del ref, ref_wide
        del a, wide, pick


def fp2_pow_rows(chk, usage, gen, device) -> None:
    """Phase kernels' rows of `fp2_pow_fixed` into `chk` (KernelChecks;
    `usage`: ptxas registers and spill bytes by kernel): FP2_POW_EXPONENTS
    at FP2_POW_WIDTHS over the Fp2 edge lanes, one plain call per exponent
    at 1024 lanes whose first lanes (lane 9, random, for B = 1) hold the
    narrower launches, and at FP2_POW_WIDE lanes held on sampled lanes;
    the plain version timed once, at (p-1)/2 (2.4-3 s a call on the card).
    The square roots' exponents timed at FP2_POW_TIMED_WIDTHS."""
    import torch

    from bls12_381_torch.kernels import mont

    a0, a1 = fp2_pow_operand(BATCH, gen, device)
    w0, w1 = fp2_pow_operand(FP2_POW_WIDE, gen, device)
    pick = sample_lanes(FP2_POW_WIDE, gen, device)
    n = mont.FP2_POW_LANES
    regs, spills = usage["fp2_pow_fixed"]
    for label in FP2_POW_EXPONENTS:
        e = exponent(label)
        ref = torch.stack(mont.fp2_pow_plain(a0, a1, e))
        ref_wide = torch.stack(mont.fp2_pow_plain(
            w0.index_select(1, pick), w1.index_select(1, pick), e))
        for B in FP2_POW_WIDTHS + (FP2_POW_WIDE,):
            if B == FP2_POW_WIDE:
                x0, x1, want, lanes_held = w0, w1, ref_wide, pick
            else:
                held = slice(0, B) if B > 1 else slice(9, 10)
                x0, x1 = a0[:, held].contiguous(), a1[:, held].contiguous()
                want, lanes_held = ref[..., held], None
            key = f"fp2_pow_fixed {label} B={B}"
            timed = label in FP2_POW_TIMED and B in FP2_POW_TIMED_WIDTHS
            n_bytes, n_imads = fp2_pow_work(e, B)
            chk.hold(key, lambda x0=x0, x1=x1, e=e: torch.stack(
                         mont.fp2_pow_fixed(x0, x1, e)),
                     lambda x0=x0, x1=x1, e=e: torch.stack(
                         mont.fp2_pow_plain(x0, x1, e)),
                     "fp2_pow_fixed", 20 if timed else 2,
                     1 if key == f"fp2_pow_fixed (p-1)/2 B={BATCH}" else 0,
                     n_bytes, n_imads, ref=want, pick=lanes_held, lanes=n,
                     threads_per_lane=2, blocks=-(-B // n),
                     shared_bytes=FP2_POW_LANE_BYTES * n, registers=regs,
                     spill_bytes=spills, bytes_ms=bound(n_bytes, 0)[0],
                     ops_ms=bound(0, n_imads)[0])
        del ref, ref_wide
    del a0, a1, w0, w1, pick


def sqr_rows(chk, usage, gen, device, edges) -> None:
    """Phase kernels' rows of `sqr` into `chk` (KernelChecks; `usage`:
    ptxas registers and spill bytes by kernel; `edges`: the limb columns
    of 0, 1 and p-1): G = 1 and 3 at SQR_WIDTHS, lanes 0..4 the edges 0,
    1, p-1, R mod p, R^2 mod p where B > 5, the widest held on sampled
    lanes; timed at G = 1 and SQR_TIMED_WIDTHS and at G = 3 and the batch,
    each launch over rotating operand copies (from HBM)."""
    from bls12_381_torch import params
    from bls12_381_torch.kernels import mont

    P = params.P
    sqr_edges = edges + [edge_col(v, device) for v in (
        (1 << 384) % P, (1 << 768) % P)]
    regs, spills = usage["sqr"]
    per_block = mont.SQR_THREADS * mont.SQR_LANES_PER_THREAD
    for G in (1, 3):
        for B in SQR_WIDTHS:
            a = rand_fp((G, B), gen, device).transpose(0, 1).contiguous()
            if B > len(sqr_edges):
                for lane, col in enumerate(sqr_edges):
                    a[:, :, lane] = col
            timed = (G, B) == (3, BATCH) or G == 1 and B in SQR_TIMED_WIDTHS
            call, copies = rotating(mont.sqr, a) if timed else (
                lambda a=a: mont.sqr(a), 1)
            extra = {}
            if B == SQR_WIDTHS[-1]:
                lanes = sample_lanes(B, gen, device)
                plain, n_plain = (lambda a=a, i=lanes: mont.sqr_plain(
                    a.index_select(-1, i))), 0
                extra = {"pick": lanes, "sampled_lanes": len(lanes)}
            else:
                plain = lambda a=a: mont.sqr_plain(a)  # noqa: E731
                n_plain = (5 if B <= BATCH else 1) if timed else 0
            n_bytes, n_imads = 4 * G * B * 24 * 2, G * B * sqr_imads()
            chk.hold(f"sqr G={G} B={B}", call, plain, "sqr",
                     (200 if B <= BATCH else 20) if timed else 2, n_plain,
                     n_bytes, n_imads, operand_copies=copies,
                     threads=mont.SQR_THREADS,
                     lanes_per_thread=mont.SQR_LANES_PER_THREAD,
                     blocks=-(-G * B // per_block),
                     param_bytes=SQR_PARAM_BYTES, registers=regs,
                     spill_bytes=spills, bytes_ms=bound(n_bytes, 0)[0],
                     ops_ms=bound(0, n_imads)[0], **extra)
            del a, call


def phase_kernels(device, usage):
    """Each kernel timed at the main paths' shapes (`usage`: ptxas
    registers and spill bytes by kernel, printed with the plan, power and
    row kernels' launches).

    Returns the results, per shape the call whose device time
    `phase_kernel_times` reads later, and the launch counts of the paths
    whose row kernel calls it records (pairing, msm_g1, ntt, each row of
    SMUL_ROWS) and of one msm_g2, by path."""
    import numpy as np
    import torch

    from bls12_381_torch import entry, limbs, params
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.kernels import LAUNCHES, mont, plan_exec as pe
    from bls12_381_torch.ops import msm, ntt
    from bls12_381_torch.pairing import gt

    P, Q = params.P, params.Q
    mods = {"g1": g1, "g2": g2, "gt": gt}
    MSM_PLAN_SHAPES = msm_plan_shapes()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    edges = [edge_col(v, device) for v in (0, 1, P - 1)]
    n_sm = mont.sm_count(device.index)
    chk = KernelChecks()
    paths = {}

    def hold_rows(key, calls, n_events=20, n_plain=2, shape_of=None,
                  **extra):
        """Recorded or built `sop_rows` calls, replayed in one call against
        `sop_rows_plain`; shape_of(call) forces a launch shape."""
        def shape(c):
            return None if shape_of is None else shape_of(c)

        work = [rows_work(c) for c in calls]
        launch = [rows_launch(c, n_sm, usage, shape(c)) for c in calls]
        kernel = "sop_rows_fr" if calls[0][0].n_limbs == 16 else "sop_rows"
        chk.hold(key,
                 lambda: torch.cat([mont.sop_rows(*c, shape=shape(c))
                                    .reshape(-1) for c in calls]),
                 lambda: torch.cat([mont.sop_rows_plain(*c).reshape(-1)
                                    for c in calls]),
                 kernel, n_events, n_plain, sum(w[0] for w in work),
                 sum(w[1] for w in work), launches=len(calls),
                 **(launch[0] if len(calls) == 1 else {"shapes": sorted(
                     {(len(c[4]), c[2].shape[1], int(np.prod(c[5])),
                       *ln.values()) for c, ln in zip(calls, launch)},
                     key=str)}),
                 **extra)

    def call_of(spec, rows, groups, batch):
        """A `sop_rows` call over groups of (ia, ib) row-index pairs."""
        ia, ib = fold_tables(groups)
        return (spec, rows, ia, ib, np.array([len(g) for g in groups]),
                tuple(batch))

    # --- sop: T in {1, 2, 6, 8} at the pairing's batch (its one sop, the
    # norm of fp2_inv, is T = 2 there) and the MSM's widest products (its
    # scans and to_affine, T = 1 at 2^16), T = 1 at msm_g1_large's chunk
    # width (the plain version on sampled lanes); rows are views of
    # [T, 24, B]
    for B, terms in ((BATCH, (1, 2, 6, 8)),
                     (1 << MSM_LOG_N["g1"], (1, 2, 6, 8)),
                     (MSM_LARGE_SOP_WIDTH, (1,))):
        lanes = sample_lanes(B, gen, device) \
            if B == MSM_LARGE_SOP_WIDTH else None
        for T in terms:
            a = rand_fp((T, B), gen, device).transpose(0, 1).contiguous()
            b = rand_fp((T, B), gen, device).transpose(0, 1).contiguous()
            # lanes 0..2: every operand 0, 1, p-1 (lane 2 with T = 8 is the
            # all-(p-1) carry case)
            for lane, col in enumerate(edges):
                a[:, :, lane], b[:, :, lane] = col, col
            # lane 3: a = 1, b = p - 1; lane 4: a = p - 1, b = 0
            a[:, :, 3], b[:, :, 3] = edges[1], edges[2]
            a[:, :, 4], b[:, :, 4] = edges[2], edges[0]
            c = call_of(limbs.FP, list(a) + list(b),
                        [[(t, T + t) for t in range(T)]], (B,))
            call, copies = rotating(mont.sop, a, b)
            if lanes is None:
                plain, n_plain, extra = (
                    lambda a=a, b=b: mont.sop_plain(a, b)), 3, {}
            else:
                plain, n_plain, extra = (
                    lambda a=a, b=b, i=lanes: mont.sop_plain(
                        a.index_select(-1, i), b.index_select(-1, i))), 0, {
                    "pick": lanes, "sampled_lanes": len(lanes)}
            chk.hold(f"sop T={T} B={B}", call, plain, "sop_rows",
                     50, n_plain, 4 * B * 24 * (2 * T + 1), B * sop_imads(T),
                     operand_copies=copies, **rows_launch(c, n_sm, usage),
                     **extra)

    # --- sqr (mont_sqr.cuh)
    sqr_rows(chk, usage, gen, device, edges)

    # --- plan_exec: every plan at one lane, a ragged last tile and the
    # pairing's batch; the group-law plans also at the MSM's widths: add at
    # the segmented scan's top level (half the GLV / GLS lanes), double at
    # the window loop's single lane
    def hold_plan(make_plan, B, sampled=False):
        plan = pe.compile_plan(make_plan())
        ops = rand_fp((plan.n_in, B), gen, device).transpose(0, 1) \
            .contiguous()
        plan_edge_lanes(ops, P)
        lt, threads, smem = plan.launch_shape(B, n_sm)
        extra = {}
        if sampled:
            lanes = sample_lanes(B, gen, device)
            extra = {"pick": lanes, "sampled_lanes": len(lanes)}
        chk.hold(f"plan_exec {plan.name} B={B}",
                 lambda ops=ops, plan=plan: pe.plan_exec(ops, plan),
                 lambda ops=ops, plan=plan: pe.plan_exec_plain(
                     ops.index_select(-1, extra["pick"]) if sampled
                     else ops, plan),
                 "plan_exec", 20, 0 if sampled else 2,
                 96 * B * (plan.n_in + plan.n_out),
                 B * sum(sop_imads(t) for t in plan.sop_terms()),
                 nodes=len(plan.instr), groups=len(plan.groups),
                 phases=len(plan.phases), slots=plan.n_slots,
                 sop_nodes=len(plan.sop_terms()), lane_tile=lt,
                 blocks=-(-B // lt), threads=threads, smem_bytes=smem,
                 registers=usage["plan_exec"][0], **extra)

    msm_widths = {}
    for make_plan, B in MSM_PLAN_SHAPES:
        msm_widths.setdefault(make_plan, set()).add(B)
    # the scalar multiplication rows' widest add and double launches
    for make_plan, _ in MSM_PLAN_SHAPES[:4]:
        msm_widths[make_plan].add(SMUL_PLAN_WIDTH)
    for make_plan in pe.MAIN_PATH_PLANS + pe.GROUP_LAW_PLANS:
        for B in sorted({1, PLAN_RAGGED, BATCH} | msm_widths.get(make_plan,
                                                                 set())):
            hold_plan(make_plan, B)
    # msm_g1_large's widest group adds: the scans' top level at its chunk
    # widths (the plain version on sampled lanes)
    for B in MSM_LARGE_PLAN_WIDTHS:
        hold_plan(pe.g1_add_plan, B, sampled=True)

    # --- plan_exec's fold mode: the MSM's bucket sums over every window's
    # GLV lanes (c = 12, 11 windows) at 2^20 points and at a blob's 4096,
    # the entry's points and scalars: the first level's launch (one mixed
    # addition a lane) and the whole fold, each = its plain version
    for log_n in FOLD_LOG_N:
        pts, sc = entry.msm_inputs(log_n, "g1", seed=SEED, device=device)
        aff, mags, negs = msm._recode_g1(pts, sc, 12, True)
        order, dest, negs, n_out = msm._window_lanes(
            msm._sort_digits(mags, negs), 12)
        table = pe.pack_words(list(aff))
        K = dest.shape[0]
        levels = msm.fold_levels(K)
        one = msm._identity_mask(g1.CURVE)

        def level1(kernel, order=order, dest=dest, negs=negs, n_out=n_out,
                   table=table, M=levels[0][1]):
            plan = pe.compile_plan(pe.g1_add_mixed_plan(), fold=True)
            totals = torch.stack([r for c in g1.identity((n_out,), device)
                                  for r in g1.CURVE.f.rows(c)]).contiguous()
            fold = pe.Fold(table, dest, order, negs, (1, 2), one_mask=one)
            if kernel:
                nxt = pe.plan_fold(plan, fold, M, totals)
                part, content = nxt.src, nxt.content
            else:
                part, content = pe.plan_fold_plain(plan, fold, M, totals)
            return torch.cat([totals.reshape(-1), part.reshape(-1),
                              content.to(totals.dtype)])

        def whole(kernel, order=order, dest=dest, negs=negs, n_out=n_out,
                  table=table):
            # the plain version on the card's tensors: plan_fold's route
            # read as the CPU's
            route = pe.device_kind
            if not kernel:
                pe.device_kind = lambda x: "cpu"
            try:
                sums = msm._fold_sums(g1, table, order, dest, n_out, negs)[0]
            finally:
                pe.device_kind = route
            return torch.cat(sums, -1)

        mixed = pe.compile_plan(pe.g1_add_mixed_plan(), fold=True)
        full = pe.compile_plan(pe.g1_add_plan(), fold=True)
        first_bytes = K * (96 + 8 + 8 + 1)
        chk.hold(f"plan_fold {mixed.name} K={K}", lambda f=level1: f(True),
                 lambda f=level1: f(False), "plan_exec", 20, 0, first_bytes,
                 K * sum(sop_imads(t) for t in mixed.sop_terms()),
                 lanes=K, run_lanes=levels[0][1],
                 slots=mixed.n_slots, registers=usage["plan_exec fold"][0])
        later = sum(k for k, _ in levels[1:])
        chk.hold(f"plan_fold g1 all levels K={K}", lambda f=whole: f(True),
                 lambda f=whole: f(False), "plan_exec", 10, 0,
                 first_bytes + later * (144 + 8 + 1),
                 K * sum(sop_imads(t) for t in mixed.sop_terms())
                 + later * sum(sop_imads(t) for t in full.sop_terms()),
                 launches=len(levels), lanes=K, levels=len(levels),
                 level_lanes=[k for k, _ in levels])

    # --- fold_planned: the line scaling's shape (G = 4, T = 1 over 68 x
    # 1024 lanes), a fold of Fp2 products (G = 8, T = 2) and uneven groups
    # up to T = 6 whose first group multiplies the all-(p-1) row by itself
    # six times; lanes 0..2 of every other row hold 0, 1, p-1; rows are
    # views of the [K, 24, B] stack, row 0 zeros for the padding terms
    for G, T, B, groups in FOLD_CASES:
        K = 1 + max(i for g in groups for pair in g for i in pair)
        ops = rand_fp((K, B), gen, device).transpose(0, 1).contiguous()
        for lane, col in enumerate(edges):
            ops[:, :, lane] = col
        ops[0] = 0
        if T == 6:
            ops[K - 1] = edges[2].unsqueeze(-1)
        ia, ib = fold_tables(groups)
        call, copies = rotating(
            lambda ops, ia=ia, ib=ib: mont.fold_planned(ops, ia, ib), ops)
        chk.hold(f"fold_planned G={G} T={T} B={B}", call,
                 lambda ops=ops, ia=ia, ib=ib: mont.fold_planned_plain(
                     ops, ia, ib),
                 "sop_rows", 50, 3, fold_bytes(B, groups),
                 B * sum(sop_imads(len(g)) for g in groups),
                 operand_copies=copies,
                 **rows_launch(call_of(limbs.FP, list(ops), groups, (B,)),
                               n_sm, usage))

    # --- the operand layouts the row kernel reads in place, at the paths'
    # sizes, and the one it copies: the pairing's line scaling (movedim
    # views of the [68, 3, 2, 24, B] coefficients, yp and xp expanded over
    # 68), a product scan level over 0::2 / 1::2 lanes, batch_inv's
    # inverted totals [24, n, 1] against [24, n, m], a [24, 1] constant,
    # and outer batch axes that do not collapse (copied_rows must be 1)
    coeffs = rand_fp((68 * 3 * 2 * BATCH,), gen, device).reshape(
        24, 68, 3, 2, BATCH).permute(1, 2, 3, 0, 4).contiguous()
    yp, xp = rand_fp((BATCH,), gen, device), rand_fp((BATCH,), gen, device)
    comp = [coeffs[:, i, j].movedim(1, 0)
            for i, j in ((0, 0), (0, 1), (2, 0), (2, 1))]
    n1, n2 = (1 << MSM_LOG_N[g] for g in ("g1", "g2"))
    scan = rand_fp((n1,), gen, device)
    others = rand_fp((16, n2), gen, device)
    totals = rand_fp((16, 1), gen, device)
    flat = rand_fp((n1,), gen, device)
    twisted = rand_fp((2, 3, n2), gen, device).transpose(1, 2)
    layouts = {
        "line scaling, movedim views and yp, xp expanded over 68":
            call_of(limbs.FP, comp + [yp.unsqueeze(1).expand(24, 68, BATCH),
                                      xp.unsqueeze(1).expand(24, 68, BATCH)],
                    [[(0, 4)], [(1, 4)], [(2, 5)], [(3, 5)]], (68, BATCH)),
        "scan level, 0::2 x 1::2": call_of(
            limbs.FP, [scan[:, 0::2], scan[:, 1::2]], [[(0, 1)]],
            (scan.shape[1] // 2,)),
        "[24, n, 1] x [24, n, m]": call_of(
            limbs.FP, [others, totals], [[(0, 1)]], (16, n2)),
        "[24, 1] constant x [24, B]": call_of(
            limbs.FP, [flat, edges[2].unsqueeze(-1)], [[(0, 1)]],
            (flat.shape[1],)),
        "non-affine [24, 3, 2, n], copied": call_of(
            limbs.FP, [twisted, rand_fp((3, 2, n2), gen, device)],
            [[(0, 1)], [(1, 1), (0, 0)]], (3, 2, n2)),
    }
    for label, c in layouts.items():
        LAUNCHES.reset()
        mont.sop_rows(*c)
        hold_rows(f"sop_rows {label}", [c], n_events=50, n_plain=2,
                  copied_rows=LAUNCHES.copied_rows)
    del coeffs, comp, scan, others, totals, flat, twisted, layouts

    # the calls of one pairing at batch 1024 as the pairing makes them:
    # its 31 folds (the line scaling, the inversions' and Frobenius maps'
    # Fp2 / Fp6 products; the kernels line's `fold_planned` row) and its
    # norm (fp2_inv, T = 2: the `sop` row), each replayed in one call, per
    # launch at the pairing's own mix
    fn, (p_aff, q_aff) = entry.entry(BATCH, device)
    calls = recorded(paths, "pairing", lambda: fn(p_aff, q_aff))
    del p_aff, q_aff
    folds = [c for c in calls if len(c[4]) > 1]
    norms = [c for c in calls if len(c[4]) == 1]
    hold_rows(PAIRING_FOLDS, folds)
    hold_rows(PAIRING_NORM, norms, n_events=50, n_plain=3)

    # the chosen launch shape beside split = 1 and a 32-lane tile of one
    # thread per group, on the pairing's folds and norm and on the shapes
    # that set the policy (the device times come from phase kernel_times)
    def forced(split=None, tile=None):
        def shape(c):
            G, T = c[2].shape
            B = int(np.prod(c[5]))
            if tile:
                return tile, min(G, mont.SOP_THREADS // tile), 1
            return mont.sop_launch_shape(G, T, B, n_sm, split=split)
        return shape

    for G, T, B in ((6, 6, BATCH), (12, 3, BATCH), (2, 1, BATCH),
                    (4, 6, n2), (8, 2, n1)):
        label = f"G={G} T={T} B={B}"
        rows = list(rand_fp((2 * T, B), gen, device).transpose(0, 1))
        c = call_of(limbs.FP, rows, [[(t % (2 * T), (t + g) % (2 * T))
                                      for t in range(T)]
                                     for g in range(G)], (B,))
        for name, shape_of in (("chosen", None), ("split 1", forced(1)),
                               ("tile 32", forced(tile=32))):
            hold_rows(f"sop_rows {label} {name}", [c], n_events=50,
                      n_plain=1, shape_of=shape_of)
    for key, calls_ in ((PAIRING_FOLDS, folds), (PAIRING_NORM, norms)):
        for name, shape_of in (("split 1", forced(1)),
                               ("tile 32", forced(tile=32))):
            hold_rows(f"{key} {name}", calls_, shape_of=shape_of,
                      n_plain=0 if key == PAIRING_FOLDS else 1)
    del calls, folds, norms

    # the products of one msm_g1 as it makes them (to_affine's product
    # scans and per-lane products, the GLV split's beta x), replayed in one
    # call: per launch at the MSM's own mix (the kernels line's `sop` row
    # reads it beside the pairing's norm)
    fn, (pts, sc) = entry.msm_entry(MSM_LOG_N["g1"], "g1", seed=SEED,
                                    device=device)
    sops = [c for c in recorded(paths, "msm_g1", lambda: fn(pts, sc))
            if c[0] is limbs.FP and len(c[4]) == 1]
    hold_rows(MSM_SOPS, sops)
    fn, (pts, sc) = entry.msm_entry(MSM_LOG_N["g2"], "g2", seed=SEED,
                                    device=device)
    recorded(paths, "msm_g2", lambda: fn(pts, sc))
    del fn, pts, sc, sops

    # the row kernel's calls of one call of each row of SMUL_ROWS at its
    # width, recorded and replayed by route (the kernels line puts their
    # ms per launch beside its sop, fold_planned and sop_fr rows): beta x,
    # the scalars' from_mont, the psi and Frobenius folds, eq's folds at
    # 4096 lanes, batch_normalize's scans and products at 10,000
    for group, name, n in SMUL_ROWS:
        label = smul_label(group, name, n)
        args = smul_args(group, name, n, device)
        fn = getattr(mods[group], name)
        calls = recorded(paths, label, lambda fn=fn, args=args: fn(*args))
        for route in ("sop", "fold_planned", "sop_fr"):
            mine = [c for c in calls if row_route(c) == route]
            if mine:
                hold_rows(smul_rows_key(route, label), mine)
        del args, calls

    pow_rows(chk, usage, gen, device)
    fp2_pow_rows(chk, usage, gen, device)

    # --- Fr: sop_fr (T = 1, 2) and butterfly at B = 2^16 with edge rows,
    # and at the NTT's shapes: the 1/N scaling (T = 1, B = N) and a stage
    # (B = N/2)
    fr_edges = [edge_col(v, device, 16) for v in (0, 1, Q - 1, Q - 2)]
    for T, B in ((1, 1 << 16), (2, 1 << 16), (1, NTT_N)):
        a = rand_fr((T, B), gen, device).transpose(0, 1).contiguous()
        b = rand_fr((T, B), gen, device).transpose(0, 1).contiguous()
        # lanes 0..3: every operand 0, 1, q-1, q-2; lane 4: 1 x (q-1);
        # lane 5: (q-1) x 0
        for lane, col in enumerate(fr_edges):
            a[:, :, lane], b[:, :, lane] = col, col
        a[:, :, 4], b[:, :, 4] = fr_edges[1], fr_edges[2]
        a[:, :, 5], b[:, :, 5] = fr_edges[2], fr_edges[0]
        c = call_of(limbs.FR, list(a) + list(b),
                    [[(t, T + t) for t in range(T)]], (B,))
        call, copies = rotating(mont.sop_fr, a, b)
        chk.hold(f"sop_fr T={T} B={B}", call,
                 lambda a=a, b=b: mont.sop_fr_plain(a, b), "sop_rows_fr",
                 50, 3, 4 * B * 16 * (2 * T + 1), B * sop_imads(T, 8),
                 operand_copies=copies, **rows_launch(c, n_sm, usage))
    # the twiddle doublings of one ntt as it makes them: T = 1 at the widths
    # 1, 2, ..., N/4, the step constant a [16, 1] row read in place (the
    # kernels line's `sop_fr` row)
    x = entry.ntt_inputs(NTT_LOG_N, seed=SEED, device=device)
    doublings = recorded(paths, "ntt", lambda: ntt.ntt(x))
    del x
    hold_rows(DOUBLINGS, doublings)
    del doublings
    for B in (1 << 16, NTT_N // 2):
        a, b, w = rand_fr((3, B), gen, device).unbind(1)
        # lanes 0..5: the rows whose lo takes the -q correction and whose
        # hi takes the +q correction (tests/test_device_fields.py:529-531);
        # lanes 6..9: every operand 0, 1, q-1, q-2
        rows = {"a": (0, 1, Q - 1, Q - 2, 0, Q - 1),
                "b": (Q - 1, 0, Q - 1, 1, 0, 1),
                "w": (Q - 1, 5, Q - 1, 1, 7, Q - 1)}
        for x, key in ((a, "a"), (b, "b"), (w, "w")):
            for lane, v in enumerate(rows[key]):
                x[:, lane] = edge_col(v, device, 16)
            for lane, col in enumerate(fr_edges):
                x[:, 6 + lane] = col
        a, b, w = a.contiguous(), b.contiguous(), w.contiguous()
        call, copies = rotating(mont.butterfly, a, b, w)
        chk.hold(f"butterfly B={B}", call,
                 lambda a=a, b=b, w=w: mont.butterfly_plain(a, b, w),
                 "butterfly", 50, 3, B * BUTTERFLY_BYTES,
                 B * BUTTERFLY_IMADS, operand_copies=copies)
    if chk.failures:
        fail(f"kernel and plain version disagree: {chk.failures}")
    return chk.results, chk.timed, paths


def phase_counts(device, paths) -> None:
    """The launches of one call of each path whose row-kernel calls the
    timer does not replay, counted into paths: the BLS round trip at
    2^BLS_LOG_N lanes (the sqr, Fp2 power and hash rows read its counts),
    the codec rows at 2^CODEC_LOG_N (each decoder with its checks on, each
    encoder on the decoded points), the hash to curve rows at 2^H2C_LOG_N
    and msm_g1_large at 2^20 and 2^24 (window MSM_LARGE_C, the default
    chunk); as `oracle_<check>` the calls the host oracle checks in the
    card tests (the multi-pairing, psi, the Fr functions and codecs, the Fp
    decoder); as `parallel_<row>_r<world>` rank 0's call of each sharded
    path on one NCCL rank and on PARALLEL_RANKS gloo ranks on this card."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from bls12_381_torch import entry, pairing as pr
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.fields import fp, fr
    from bls12_381_torch.kernels import build
    from bls12_381_torch.ops import ntt

    counted(paths, "bls_round_trip",
            lambda: bls_round_trip(1 << BLS_LOG_N, device))
    n = 1 << CODEC_LOG_N
    for group, mod in (("g1", g1), ("g2", g2)):
        for form in CODEC_FORMS:
            fn, (data,) = entry.codec_entry(CODEC_LOG_N, group, form, device)
            aff, _ = counted(paths, f"{group}_from_{form}_host_{n}",
                             lambda: fn(data))
            enc = getattr(mod, f"to_{form}_host")
            counted(paths, f"{group}_to_{form}_host_{n}", lambda: enc(aff))
    for group, kind in H2C_ROWS:
        fn, args = entry.h2c_entry(H2C_LOG_N, group, kind, device)
        counted(paths, f"{kind}_to_curve_{group}_{1 << H2C_LOG_N}",
                lambda: fn(*args))
    for log_n in MSM_LARGE_LOG_NS:
        fn, (pts, sc) = entry.msm_entry(log_n, "g1", seed=SEED,
                                        device=device)
        label = "msm_g1_large" if log_n > MSM_LARGE_LOG_NS[0] else "msm_g1"
        counted(paths, f"{label}_2^{log_n}",
                lambda: fn(pts, sc, MSM_LARGE_C))
        del fn, pts, sc

    ins = oracle_inputs()
    p_aff, q_aff = encode(
        [(0, 0, True) if p is None else (*p, False) for p, _ in ins["terms"]],
        [((0, 0), (0, 0), True) if q is None else (*q, False)
         for _, q in ins["terms"]], device)
    counted(paths, "oracle_multi_pairing", lambda: pr.final_exponentiation(
        pr.multi_miller_loop(p_aff, pr.prepare_g2(q_aff))))
    pts, _ = entry.msm_inputs(PSI_LOG_N, "g2", seed=SEED, device=device)
    counted(paths, "oracle_psi", lambda: g2.psi(pts))
    a = fr.from_ints(ins["fr_vals"], device=device)
    counted(paths, "oracle_fr_sqrt", lambda: fr.sqrt(a))
    a = fr.from_ints([v for v in ins["fr_vals"] if v], device=device)
    counted(paths, "oracle_fr_inv", lambda: fr.inv(a))
    rows = np.frombuffer(b"".join(ins["fr_rows"]), np.uint8).reshape(-1, 32)
    m, _ = counted(paths, "oracle_fr_from_bytes",
                   lambda: fr.from_bytes_host(rows, device=device))
    counted(paths, "oracle_fr_to_bytes", lambda: fr.to_bytes_host(m))
    rows = np.frombuffer(b"".join(ins["wide"]), np.uint8).reshape(-1, 64)
    counted(paths, "oracle_fr_from_bytes_wide",
            lambda: fr.from_bytes_wide_host(rows, device=device))
    counted(paths, "oracle_fp_from_bytes",
            lambda: fp.from_bytes_host(ins["fp_rows"], device=device))
    del ins, p_aff, q_aff, pts, a, rows, m

    build.build_all()  # the spawned ranks load the libraries, not build
    x = entry.ntt_inputs(NTT_LOG_N, seed=SEED, device=device)
    inputs = {"pairing": pairing_inputs(device)[2:], "ntt": {NTT_LOG_N: x},
              "ntt_y": {NTT_LOG_N: ntt.ntt(x)},
              **{f"msm_{g}": entry.msm_inputs(log_n, g, seed=SEED,
                                              device=device)
                 for g, log_n in MSM_LOG_N.items()}}
    spec = {"device": str(device), "window": PARALLEL_WINDOW, "reps": 1,
            "values": False}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "inputs.pt")
        torch.save(to_cpu(inputs), path)
        del x, inputs
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            ranks = {1: parallel_job(spec, path)}
        finally:
            dist.destroy_process_group()
        ranks[PARALLEL_RANKS] = spawn_ranks(PARALLEL_RANKS, "gloo", spec,
                                            path, tmp)[0]
    for world, rows in ranks.items():
        for row, r in rows.items():
            if row not in NOT_ROWS:
                paths[f"parallel_{row}_r{world}"] = r["launches"]


# ---------------------------------------------------------------------------
# The device hash expanders
# ---------------------------------------------------------------------------


def phase_hashes(device, usage, results, timed) -> None:
    """The hash kernels (csrc/sha256.cu, csrc/keccak.cu) timed into
    `results` / `timed` (`KernelChecks`; their device times come from phase
    kernel_times): at HASH_TIMED_WIDTHS and at one lane (one thread's
    chain), the G2 hash's XMD (32 bytes to 256 under the bench DST), the
    digest of 32 bytes and the SHAKE-128 XOF of the XMD's shape; the plain
    versions timed below 2^16 lanes."""
    import numpy as np
    import torch

    from bls12_381_torch.kernels import keccak, sha256

    big = max(HASH_TIMED_WIDTHS)
    t = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (big, 32), dtype=np.uint8)).to(device)
    chk = KernelChecks()
    d10 = len(HASH_DST)
    for B in (1,) + HASH_TIMED_WIDTHS:
        x = t[:B]
        n_plain = 1 if B < big else 0
        launch = {"threads": 128, "blocks": -(-B // 128)}
        n_bytes, n_ops = xmd_work(B, 32, 256, d10)
        chk.hold(f"xmd_sha256 msg=32 out=256 dst={d10} B={B}",
                 lambda x=x: sha256.expand_message_xmd_sha256(
                     x, HASH_DST, 256).T,
                 lambda x=x: sha256.expand_message_xmd_sha256_plain(
                     x, HASH_DST, 256).T,
                 "xmd_sha256", 20, n_plain, n_bytes, n_ops,
                 registers=usage["xmd_sha256"][0],
                 spill_bytes=usage["xmd_sha256"][1],
                 load=sha256.io_width(x.data_ptr(), 32),
                 store=sha256.io_width(0, 256),
                 param_bytes=len(sha256.xmd_params(HASH_DST, 256, 32)),
                 instance_registers={k: usage[k] for k in usage
                                     if k.startswith("xmd_sha256")},
                 bytes_ms=bound(n_bytes, 0)[0], ops_ms=bound(0, n_ops)[0],
                 **launch)
        chk.hold(f"sha256 msg=32 B={B}", lambda x=x: sha256.sha256(x).T,
                 lambda x=x: sha256.sha256_plain(x).T, "sha256", 20,
                 n_plain, B * (32 + 32),
                 B * sha256_blocks(32) * SHA256_COMPRESSION_OPS,
                 registers=usage["sha256"][0],
                 spill_bytes=usage["sha256"][1], **launch)
        chk.hold(f"shake xof128 msg=32 out=256 dst={d10} B={B}",
                 lambda x=x: keccak.expand_message_xof_shake(
                     x, HASH_DST, 256).T,
                 lambda x=x: keccak.expand_message_xof_shake_plain(
                     x, HASH_DST, 256).T,
                 "shake", 20, n_plain,
                 *shake_work(B, 32 + 2 + d10 + 1, 32, 256, 168),
                 registers=usage["shake"][0],
                 spill_bytes=usage["shake"][1], **launch)
    if chk.failures:
        fail(f"hash kernel and plain version disagree: {chk.failures}")
    results.update(chk.results)
    timed.extend(chk.timed)


def phase_kernel_times(results, timed) -> None:
    """Each kernel's device time per launch at the shapes of phase kernels,
    into results[key]["ms"]: the mean duration of its launches (of a
    call's launches, for a call that makes several) as the profiler
    records them on the card.  (CUDA events around back-to-back
    calls time the host's issue rate for kernels that finish faster than
    Python and ctypes can launch them.)  One profiler session runs every
    shape's launches in turn; each kernel's events, in order, are split
    by shape."""
    import torch

    def run_all():
        for _, call, _, n, _ in timed:
            for _ in range(n):
                call()
            torch.cuda.synchronize()

    evs = sorted(device_events(run_all), key=lambda ev: ev[1])
    durs = {}
    for kernel in {t[2] for t in timed}:
        durs[kernel] = [(end - start, name) for name, start, end in evs
                        if kernel_of(name) == kernel]
        want = sum(n * per for _, _, k, n, per in timed if k == kernel)
        if len(durs[kernel]) != want:
            fail(f"profiler recorded {len(durs[kernel])} launches of "
                 f"{kernel}, not {want}")
    for key, _, kernel, n, per in timed:
        mine, durs[kernel] = durs[kernel][:n * per], durs[kernel][n * per:]
        results[key]["ms"] = sum(d for d, _ in mine) / (n * per) / 1e3
        if "threads_per_lane" in results[key]:  # the instance it launched
            shape = (f", {results[key]['threads_per_lane']}, "
                     f"{results[key]['lanes']}>")
            if kernel.startswith("pow_fixed") and not all(
                    shape in name for _, name in mine):
                fail(f"{key}: launched {mine[0][1][:80]}, not the "
                     f"instance <..{shape}")
        say("kernel_times", kernel=key, ms=results[key]["ms"],
            events_ms=results[key]["events_ms"],
            bound_ms=results[key]["bound_ms"])


def smul_label(group: str, name: str, n: int) -> str:
    return f"{group}_{name}_{n}"


def smul_args(group: str, name: str, n: int, device):
    """The inputs of a row of SMUL_ROWS at n lanes: scalar_mul's from
    entry.smul_inputs, the others' the points [i+1]G of entry.msm_inputs
    (the identity at i % 64 == 5; z is not one)."""
    from bls12_381_torch import entry
    from bls12_381_torch.utils import scans

    if name == "scalar_mul":
        return entry.smul_inputs(n.bit_length() - 1, group, seed=SEED,
                                 device=device)
    pts, _ = entry.msm_inputs((n - 1).bit_length(), group, seed=SEED,
                              device=device)
    return (scans.tree_map(lambda t: t[..., :n].contiguous(), pts),)


def row_route(call) -> str:
    """The counter a recorded `sop_rows` call adds to: sop (Fp, one
    group), fold_planned (Fp, G >= 2) or sop_fr (Fr)."""
    if call[0].n_limbs == 16:
        return "sop_fr"
    return "fold_planned" if len(call[4]) > 1 else "sop"


def smul_rows_key(route: str, label: str) -> str:
    return f"{route} calls of one {label}"


def main() -> None:
    t_all = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "bls12_381_torch" / "kernels" / "csrc").is_dir():
        fail("run from a checkout of the repository (bls12_381_torch/ next "
             "to this script)")
    sys.path.insert(0, str(ROOT))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        say("phase", name=name, seconds=time.perf_counter() - t0)
        return out

    smi_line = phase("device", phase_device)
    usage = phase("build", phase_build)
    results, timed, paths = phase("kernels", phase_kernels, device, usage)
    phase("hashes", phase_hashes, device, usage, results, timed)
    phase("counts", phase_counts, device, paths)
    phase("kernel_times", phase_kernel_times, results, timed)
    kernels = kernel_rows(results, paths, usage)
    say("phase", name="total", seconds=time.perf_counter() - t_all)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def kernel_rows(results: dict, paths: dict, usage: dict) -> list:
    """The `kernels` JSON line's rows, one a kernel (and plan): its source,
    the TPU kernel it replaces, launches per pairing (per ntt for the Fr
    kernels, per msm for the group-law plans, per BLS round trip for sqr,
    the Fp2 power and the hash kernels) and per counted path, and the
    timed rows' numbers at its main shape with other shapes beside them."""
    from bls12_381_torch.kernels import plan_exec as pe

    counts, counts_ntt = paths["pairing"], paths["ntt"]
    bls = paths["bls_round_trip"]
    msm_counts = {g: paths[f"msm_{g}"] for g in ("g1", "g2")}

    def path_launches(counter, plan=None):
        """A kernel's launches in one call of each counted path."""
        return {f"launches_{label}": (
            c["plan_exec_by_plan"].get(plan, 0) if plan else c[counter])
            for label, c in paths.items()}

    def entry(name, source, replaces, launches, key, **extra):
        r = results[key]
        counter, _, plan = name.partition(":")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None,
                "shape": key, "mismatches": r["mismatches"],
                **path_launches(counter, plan), **extra}

    src = "bls12_381_torch/kernels/csrc/"
    pallas = "bls12_381_tpu/kernels/pallas_mont.py"
    plan_src = "bls12_381_tpu/kernels/plan_exec.py:778"

    def beside(prefix, key):
        """Another shape's numbers for a row: ms, bound, plain, errors."""
        r = results[key]
        return {f"{prefix}_shape": key, **{f"{prefix}_{k}": r[k] for k in (
            "ms", "bound_ms", "plain_ms", "mismatches", "max_abs_err")}}

    def smul_beside(route):
        """The row kernel's calls of each row of SMUL_ROWS on one route,
        replayed in phase kernels: their numbers per launch."""
        out = {}
        for group, name, n in SMUL_ROWS:
            label = smul_label(group, name, n)
            if smul_rows_key(route, label) in results:
                out.update(beside(label, smul_rows_key(route, label)))
        return out

    def launch(key):
        """A row-kernel row's launch shape(s), as phase kernels printed."""
        return {k: v for k, v in results[key].items() if k in (
            "lane_tile", "group_slots", "threads_per_group", "blocks",
            "threads", "param_bytes", "registers", "spill_bytes", "shapes")}

    rows_note = ("the row kernel sop_rows_kernel<F> of csrc/montgomery.cuh, "
                 "instantiated here; its launches are sop, fold_planned "
                 "(Fp) and sop_fr (Fr)")
    kernels = [
        # per launch at the pairing's one sop (fp2_inv's norm, replayed with
        # its operands' own strides) and at the products of one msm_g1;
        # launches per pairing
        entry("sop", src + "mont.cu", f"{pallas}:620", counts["sop"],
              PAIRING_NORM, note=rows_note, **launch(PAIRING_NORM),
              **beside("msm_g1", MSM_SOPS), **smul_beside("sop"),
              **beside("msm_large", f"sop T=1 B={MSM_LARGE_SOP_WIDTH}"),
              **beside("stacked", f"sop T=2 B={BATCH}")),
        # ms per launch at 1024 lanes, the wider timed rows beside it;
        # launches per BLS round trip
        entry("sqr", src + "mont_sqr.cuh", f"{pallas}:711", bls["sqr"],
              f"sqr G=1 B={BATCH}",
              note="fp.sqr of the G1 decompression and the G1 SSWU map "
                   "(built into csrc/mont.cu)",
              **{k: v for k, v in results[f"sqr G=1 B={BATCH}"].items()
                 if k in ("threads", "lanes_per_thread", "blocks",
                          "param_bytes", "registers", "spill_bytes",
                          "bytes_ms", "ops_ms")},
              **{k: v for B in SQR_TIMED_WIDTHS if B != BATCH
                 for k, v in beside(f"b{B}", f"sqr G=1 B={B}").items()},
              **beside("g3", f"sqr G=3 B={BATCH}")),
        # the JAX chain of sqr_pallas / sop_pallas launches in one launch
        entry("pow_fixed", src + "mont_pow.cuh", f"{pallas}:711",
              counts["pow_fixed"], f"pow_fixed p-2 B={BATCH}",
              note="the JAX chain is bls12_381_tpu/limbs.py:693 (pow_fixed, "
                   "a scan over sqr_pallas and sop_pallas); built into "
                   "csrc/mont.cu, its Fr instance pow_fixed_fr into "
                   "csrc/fr.cu (fr_* beside it)",
              **{k: v for k, v in results[f"pow_fixed p-2 B={BATCH}"].items()
                 if k in ("threads_per_lane", "lanes", "blocks",
                          "shared_bytes", "registers", "spill_bytes",
                          "bytes_ms", "ops_ms")},
              fr_registers=results[f"pow_fixed_fr q-2 B={BATCH}"][
                  "registers"],
              fr_threads_per_lane=results[f"pow_fixed_fr q-2 B={BATCH}"][
                  "threads_per_lane"],
              registers_by_threads_per_lane={
                  k: v for k, v in usage.items() if k.startswith("pow_")},
              **beside("b1", "pow_fixed p-2 B=1"),
              **beside(f"b{POW_WIDE}", f"pow_fixed p-2 B={POW_WIDE}"),
              **beside("p14", f"pow_fixed (p+1)/4 B={BATCH}"),
              **{k: v for B in POW_TIMED_WIDTHS
                 for k, v in beside(f"fr_b{B}",
                                    f"pow_fixed_fr q-2 B={B}").items()}),
        # launches per pairing, ms and bounds per launch at the pairing's
        # own folds
        entry("fold_planned", src + "mont.cu", f"{pallas}:250",
              counts["fold_planned"], PAIRING_FOLDS, note=rows_note,
              **launch(PAIRING_FOLDS),
              **beside("line_scaling", "sop_rows line scaling, movedim "
                       "views and yp, xp expanded over 68"),
              **smul_beside("fold_planned")),
    ]
    for make_plan in pe.MAIN_PATH_PLANS:
        plan = pe.compile_plan(make_plan())
        kernels.append(entry(
            f"plan_exec:{plan.name}", src + "plan_exec.cu", plan_src,
            counts["plan_exec_by_plan"].get(plan.name, 0),
            f"plan_exec {plan.name} B={BATCH}"))
    # the group-law plans: launches per msm of their group, the scalar
    # multiplications' widest launches beside them (and g1_add at
    # msm_g1_large's widths)
    for make_plan, B in msm_plan_shapes()[:4]:
        plan = pe.compile_plan(make_plan())
        wide = {}
        if make_plan is pe.g1_add_plan:
            for w in MSM_LARGE_PLAN_WIDTHS:
                wide.update(beside(f"b{w}", f"plan_exec {plan.name} B={w}"))
        kernels.append(entry(
            f"plan_exec:{plan.name}", src + "plan_exec.cu", plan_src,
            msm_counts[plan.name[:2]]["plan_exec_by_plan"][plan.name],
            f"plan_exec {plan.name} B={B}",
            **beside(f"b{SMUL_PLAN_WIDTH}",
                     f"plan_exec {plan.name} B={SMUL_PLAN_WIDTH}"), **wide))
    # the NTT's kernels: launches per ntt at 2^20; ms, plain ms and bound
    # per launch at the shapes the ntt launches (its twiddle doublings, a
    # stage)
    kernels.append(entry("sop_fr", src + "fr.cu", f"{pallas}:620",
                         counts_ntt["sop_fr"], DOUBLINGS, note=rows_note,
                         **launch(DOUBLINGS), **smul_beside("sop_fr")))
    kernels.append(entry("butterfly", src + "fr.cu", f"{pallas}:414",
                         counts_ntt["butterfly"], f"butterfly B={NTT_N // 2}"))
    # the Fp2 power: ms and bound per launch at B = 1024, (p-1)/2, the
    # other timed widths and (p-3)/4 beside it; launches per BLS round trip
    fp2_key = "fp2_pow_fixed (p-1)/2 B={}"
    kernels.append(entry(
        "fp2_pow_fixed", src + "fp2_pow.cuh",
        "bls12_381_tpu/fields/tower.py:287", bls["fp2_pow_fixed"],
        fp2_key.format(BATCH),
        note="the JAX fp2_pow is a lax.scan of fp2_sqr / fp2_mul / select "
             f"over sop_pallas ({pallas}:620); one launch here, two threads "
             "per lane (built into csrc/mont.cu)",
        **{k: v for k, v in results[fp2_key.format(BATCH)].items() if k in (
            "lanes", "threads_per_lane", "blocks", "shared_bytes",
            "registers", "spill_bytes", "bytes_ms", "ops_ms")},
        **{k: v for B in FP2_POW_TIMED_WIDTHS if B != BATCH
           for k, v in beside(f"b{B}", fp2_key.format(B)).items()},
        **beside("p34", f"fp2_pow_fixed (p-3)/4 B={BATCH}")))
    # the hash kernels: ms, bound and plain ms per launch at hash to
    # curve's 256 lanes, the full card's 2^16 beside them, and one lane's
    # time (the chain); launches per BLS round trip
    hashes_jax = "bls12_381_tpu/kernels/"
    d = len(HASH_DST)
    for name, key, replaces, source in (
            ("xmd_sha256", f"xmd_sha256 msg=32 out=256 dst={d}",
             "sha256_jax.py:113", "sha256.cu"),
            ("sha256", "sha256 msg=32", "sha256_jax.py:96", "sha256.cu"),
            ("shake", f"shake xof128 msg=32 out=256 dst={d}",
             "keccak_jax.py:122", "keccak.cu")):
        small, full = (f"{key} B={B}" for B in HASH_TIMED_WIDTHS)
        kernels.append(entry(
            name, src + source, hashes_jax + replaces, bls[name], small,
            note="the JAX version is jnp fused by XLA, not Pallas"
                 + ("; also replaces keccak_jax.py:164 "
                    "(expand_message_xof_shake, one launch with its "
                    "suffix)" if name == "shake" else ""),
            chain_ms=results[f"{key} B=1"]["ms"],
            threads=results[small]["threads"],
            blocks=results[small]["blocks"],
            registers=usage[name][0], spill_bytes=usage[name][1],
            **{k: v for k, v in results[small].items() if k in (
                "load", "store", "param_bytes", "instance_registers",
                "bytes_ms", "ops_ms")},
            **beside(f"b{HASH_TIMED_WIDTHS[1]}", full)))
    return kernels


if __name__ == "__main__":
    main()
