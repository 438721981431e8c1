"""The yardstick's peaks and work counts, frozen with the benchmark.

Copied from `chip_smoke.py` (`sop_imads`) and
`bls12_381_torch/utils/profiling.py` (the peak), so that a change to the
program cannot move them; a work count joins them when a metric reads it.
The peak is a published figure of one H100 SXM at its full power limit
(700 W) and 1.98 GHz; a run reports the card's power limit beside every
share.

`pippenger_products` counts the work of one G1 MSM as a textbook would,
whatever window or formulas the program uses: a kernel roofline share over
it reads the same work on every commit.
"""

from __future__ import annotations

import math

import devtrace

# 32-bit integer multiply-adds per second: 132 SMs x 64 a clock (CUDA C
# Programming Guide, compute capability 9.0) x 1.98 GHz
IMAD_PER_S = 132 * 64 * 1.98e9

FP_WORDS = 12  # 32-bit words of an Fp element


def sop_imads(T: int, words: int = FP_WORDS) -> int:
    """32-bit multiplies of a T-term sum of products over `words` words: T
    word products and the reduction's words^2 + words, a wide product
    counting lo and hi."""
    return 2 * words * words * (T + 1) + words


# Fp products of the textbook formulas on short Weierstrass curves with
# a = 0 (Explicit-Formulas Database, Jacobian coordinates): a mixed addition
# of an affine point (madd-2007-bl, 7M + 4S), a general addition
# (add-2007-bl, 11M + 5S) and a doubling (dbl-2009-l, 2M + 5S)
MADD_PRODUCTS, ADD_PRODUCTS, DBL_PRODUCTS = 11, 16, 7
GLV_HALF_BITS = 128  # each GLV half of a scalar below q


def pippenger_products(n: int, c: int) -> int:
    """Fp products of a G1 MSM over n affine points with the GLV split at
    window c: beta x for each point, then over 2n lanes of 128-bit halves
    and ceil(129 / c) windows of signed digits, one mixed addition a lane
    and window into its bucket, the running and the total sum over
    2^(c-1) buckets a window, and c doublings and an addition a window."""
    windows = math.ceil((GLV_HALF_BITS + 1) / c)
    buckets = 1 << (c - 1)
    per_window = (2 * n * MADD_PRODUCTS + 2 * buckets * ADD_PRODUCTS
                  + c * DBL_PRODUCTS + ADD_PRODUCTS)
    return n + windows * per_window


def best_window(n: int) -> int:
    """The window that minimises `pippenger_products` for n points."""
    return min(range(2, 25), key=lambda c: pippenger_products(n, c))


def port_kernels_share(run):
    """The least time of a commitment's work on one H100, in % of the time
    the program's own kernels took per traced call; None untraced.  The
    work is the cell's frozen textbook count (`fp_products`, from
    `pippenger_products` at `best_window`), each product a one-term
    Montgomery product's 32-bit multiplies, so the share reads the same
    work whatever window or formulas the program uses."""
    if run.trace is None:
        return None
    kernel_s = devtrace.port_kernel_s(run.trace) / run.trace.calls
    if kernel_s <= 0:
        return None
    least_s = (run.traffic["roofline"]["fp_products"] * sop_imads(1)
               / IMAD_PER_S)
    return 100.0 * least_s / kernel_s
