"""Carry values between the JAX package and the port.

The JAX package keeps field elements as uint32 arrays [L, *batch] of 16-bit
Montgomery limbs; the port keeps the same limbs as int32 tensors.  These
functions take the JAX package's arrays as numpy (`np.asarray` of a JAX
array) and return the port's tensors on a given device, and back, for:

  - Fp and Fp2 elements, and Fp12 as nested tuples (2 x 3 x 2 Fp);
  - affine G1 batches (x, y, inf) and G2 batches ((x0, x1), (y0, y1), inf);
  - prepared G2 coefficients (`coeffs`, `infinity`).
"""

from __future__ import annotations

import numpy as np
import torch

from .limbs import DTYPE, resolve_device
from .pairing.pairing import G2Prepared


def fp_to_torch(a, device="cuda") -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype != np.uint32 or (arr >> 16).any():
        raise ValueError("expected uint32 16-bit limbs")
    return torch.from_numpy(arr.astype(np.int32)).to(resolve_device(device))


def fp_from_torch(t: torch.Tensor) -> np.ndarray:
    if t.dtype != DTYPE:
        raise ValueError(f"expected {DTYPE} limbs, got {t.dtype}")
    return t.detach().cpu().numpy().astype(np.uint32)


def mask_to_torch(m, device="cuda") -> torch.Tensor:
    return torch.from_numpy(np.asarray(m, dtype=bool)).to(
        resolve_device(device))


def mask_from_torch(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(bool)


def fp2_to_torch(a, device="cuda"):
    return (fp_to_torch(a[0], device), fp_to_torch(a[1], device))


def fp2_from_torch(a):
    return (fp_from_torch(a[0]), fp_from_torch(a[1]))


def fp12_to_torch(a, device="cuda"):
    return tuple(tuple(fp2_to_torch(c2, device) for c2 in c6) for c6 in a)


def fp12_from_torch(a):
    return tuple(tuple(fp2_from_torch(c2) for c2 in c6) for c6 in a)


def g1_affine_to_torch(p, device="cuda"):
    x, y, inf = p
    return (fp_to_torch(x, device), fp_to_torch(y, device),
            mask_to_torch(inf, device))


def g1_affine_from_torch(p):
    x, y, inf = p
    return (fp_from_torch(x), fp_from_torch(y), mask_from_torch(inf))


def g2_affine_to_torch(q, device="cuda"):
    x, y, inf = q
    return (fp2_to_torch(x, device), fp2_to_torch(y, device),
            mask_to_torch(inf, device))


def g2_affine_from_torch(q):
    x, y, inf = q
    return (fp2_from_torch(x), fp2_from_torch(y), mask_from_torch(inf))


def g2_prepared_to_torch(coeffs, infinity, device="cuda") -> G2Prepared:
    """From the JAX package's G2Prepared fields ([68, 3, 2, L, *batch]
    uint32 coefficients and the [*batch] infinity mask)."""
    return G2Prepared(coeffs=fp_to_torch(coeffs, device),
                      infinity=mask_to_torch(infinity, device))


def g2_prepared_from_torch(prep: G2Prepared):
    """(coeffs, infinity) as numpy, the JAX package's layout."""
    return fp_from_torch(prep.coeffs), mask_from_torch(prep.infinity)
