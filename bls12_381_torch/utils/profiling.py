"""Tracing and timing helpers (counterpart of
`bls12_381_tpu/utils/profiling.py`), over `torch.profiler` and the host
clock, with the roofline of one NVIDIA H100 SXM.

Usage:
    from bls12_381_torch.utils import profiling
    with profiling.trace("traces/pairing"):
        out = pairing(p, q)
    profiling.time_fn(pairing, p, q)   # best wall seconds of reps
    profiling.fp_mul_roofline(1024, seconds)
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

# one H100 SXM at its full power limit: HBM3 bytes per second, and 32-bit
# integer multiply-adds per second, 132 SMs x 64 per clock (CUDA C
# Programming Guide throughput table, compute capability 9.0) x 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler scope over the host and, where there is a card, its
    kernels; the trace is written under logdir for TensorBoard's profiler
    plugin (or chrome://tracing)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        try:
            yield
        finally:
            _sync()


def time_fn(fn, *args, reps: int = 3, warmup: int = 1) -> float:
    """Best-of-reps wall seconds of fn(*args), each call ending in
    `torch.cuda.synchronize()` where there is a card."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    best = float("inf")
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best


def fp_mul_roofline(batch: int, seconds: float, n_limbs: int = 24) -> dict:
    """Roofline of `batch` Montgomery products over n_limbs 16-bit limbs
    (24: Fp, 16: Fr) done in `seconds`, against one H100: 32-bit
    multiplies per product 4 W^2 + W over W = n_limbs / 2 words (the
    product's and the reduction's W^2 word products, a wide product counting
    lo and hi: `chip_smoke.sop_imads(1, W)`), bytes per product the two
    operands read and the result written once (int32 limbs)."""
    words = n_limbs // 2
    imads = 4 * words * words + words
    n_bytes = 3 * 4 * n_limbs
    bound_s = batch * max(imads / IMAD_PER_S, n_bytes / HBM_BYTES_PER_S)
    return {
        "elements_per_s": batch / seconds,
        "imads_per_s": batch * imads / seconds,
        "imad_fraction_of_peak": batch * imads / seconds / IMAD_PER_S,
        "bytes_per_s": batch * n_bytes / seconds,
        "hbm_fraction_of_peak": batch * n_bytes / seconds / HBM_BYTES_PER_S,
        "bound_s": bound_s,
        "bound_by": "operations" if imads / IMAD_PER_S
        >= n_bytes / HBM_BYTES_PER_S else "bytes",
        "fraction_of_bound": bound_s / seconds,
    }
