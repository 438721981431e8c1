"""The commitment that an MSM over the benchmark's points must give.

The points are P_i = [i+1]G1, the identity at the lanes the driver names,
and the scalars k_i are read from the Montgomery limbs x_i the driver made:
k_i = x_i R^-1 mod q.  So the commitment is [k]G1 with
k = R^-1 sum_i x_i (i+1) mod q over the lanes that hold a point, and the
sum is exact integer arithmetic on the limbs (numpy dot products in blocks
small enough that no int64 sum overflows).
"""

from __future__ import annotations

import numpy as np

from . import hostmath as hm
from .params import FP_R, FR_R, G1_GEN, LIMB_BITS, P, Q

BLOCK = 1 << 20  # lanes per dot product: 2^16 * 2^20 * 2^25 < 2^63


def limb_value(limbs) -> int:
    """Little-endian 16-bit limbs -> the integer they hold."""
    return sum(int(v) << (LIMB_BITS * j) for j, v in enumerate(limbs))


def scalar_sum(mont_limbs: np.ndarray, holds_point: np.ndarray) -> int:
    """k = sum_i k_i (i+1) mod q over the lanes i where holds_point is
    true, for scalars given as Montgomery limbs [16, N]."""
    n = mont_limbs.shape[-1]
    total = 0
    for lo in range(0, n, BLOCK):
        hi = min(n, lo + BLOCK)
        w = np.arange(lo + 1, hi + 1, dtype=np.int64)
        w[~holds_point[lo:hi]] = 0
        sums = mont_limbs[:, lo:hi].astype(np.int64) @ w
        total += limb_value(sums)
    return total * pow(FR_R, -1, Q) % Q


def expected(mont_limbs: np.ndarray, holds_point: np.ndarray):
    """The affine commitment (x, y), or None for the identity."""
    return hm.g1_mul(G1_GEN, scalar_sum(mont_limbs, holds_point))


def affine(projective_limbs: np.ndarray):
    """Homogeneous projective Montgomery limbs [3, 24] (x, y, z) -> the
    affine point (x/z, y/z) as integers, or None where z = 0."""
    r_inv = pow(FP_R, -1, P)
    x, y, z = (limb_value(c) * r_inv % P for c in projective_limbs)
    if z == 0:
        return None
    z_inv = pow(z, -1, P)
    return (x * z_inv % P, y * z_inv % P)
