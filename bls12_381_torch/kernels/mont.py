"""Montgomery sum-of-products and squaring: CUDA kernels and plain versions.

`sop` replaces `bls12_381_tpu/kernels/pallas_mont.py::sop_pallas` (default
body `_sop_kernel_r12_scalar`), `sqr` replaces `sqr_pallas` (default body
`_sqr_kernel_r12_scalar`).  Source: `csrc/mont.cu` on `csrc/fp384.cuh`.

Design.  One thread per batch lane; the lane axis is innermost, so a warp's
loads of one limb row are 32 neighbouring words.  The 24 16-bit limbs of each
operand are packed into 12 32-bit words in registers, the T products are
summed into a 25-word accumulator with 32x32->64-bit multiply-adds, then one
Montgomery reduction with 32-bit digits (12 rounds, m = t0 * (-p^-1 mod 2^32))
and one conditional subtraction give the canonical result, unpacked to 16-bit
limbs.  The pre-reduction value is < T p^2, so the result is < T p^2/R + p,
which is < 2p while T p < R; R/p ~ 9.84, so the kernel takes T <= 8, as the
JAX package chunks it.  The canonical Montgomery value is unique for R, so the
32-bit digits cannot change a result (`pallas_mont.py:96-105`).

Bound on the card.  A T = 1 product reads 2 x 24 and writes 24 int32 words
per lane (288 bytes) and does 2 x 12 x 12 word products plus the reduction's
12 x 12 + 12, each a lo and a hi 32-bit multiply: about 600 IMADs per lane.
At 3.35 TB/s and 132 SMs x 64 IMAD/clock x 1.98 GHz the bytes take ~2.4x
longer than the multiplies, so T = 1 is bound by memory: 16-bit limbs stored
in int32 double the bytes read.  Larger T moves toward the multiply bound.
The kernel keeps every intermediate in registers (nothing but the operands
and the result touches device memory); packing the boundary to 32-bit words
would halve its bytes and is left to a later change.

On a CPU tensor the wrappers run the plain versions below (int64 PyTorch
following the JAX jnp algorithms, `limbs.py:280-327`); on a CUDA tensor they
launch the kernel or raise.  Nothing sends a CUDA tensor to the plain path.
"""

from __future__ import annotations

import ctypes

import torch

from .. import limbs
from . import LAUNCHES, build

L = limbs.FP.n_limbs
MAX_TERMS = 8  # T p < R for Fp (R/p ~ 9.84)
_BLOCK = 128

_SIGNATURES = {
    # (a, b, out, T, B, stream)
    "bls_sop": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
    # (a, out, G, B, stream)
    "bls_sqr": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p),
}


def _lib():
    return build.load("mont", _SIGNATURES)


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def _check_limbs(x: torch.Tensor, name: str) -> None:
    if x.dtype != limbs.DTYPE or x.dim() != 3 or x.shape[1] != L:
        raise ValueError(f"{name}: expected int32 [n, {L}, B], got "
                         f"{tuple(x.shape)} {x.dtype}")


def device_kind(x: torch.Tensor) -> str:
    """'cpu' (plain version) or 'cuda' (kernel); any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


# ---------------------------------------------------------------------------
# Plain versions (int64 over 16-bit limbs)
# ---------------------------------------------------------------------------


def _mont_reduce_plain(t: torch.Tensor) -> torch.Tensor:
    """Montgomery reduction of [2L+1, *batch] int64 lazy columns (each
    < 2^43) to canonical limbs: L rounds of 16-bit digits
    m = t_k * inv16 mod 2^16 (the jnp `_mont_reduce`, fp.rs:487-562)."""
    spec = limbs.FP
    p = limbs._col(spec.p_limbs, t)
    for k in range(L):
        m = (t[k] * spec.inv16) & limbs.MASK
        t[k:k + L] += m.unsqueeze(0) * p
        t[k + 1] += t[k] >> limbs.LIMB_BITS
    out = limbs._carry_prop(t[L:], L + 1, passes=2)
    return limbs._cond_sub_p(spec, out)


def sop_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(sum_t a[t] b[t]) R^-1 mod p for int32 [T, L, *batch] -> [L, *batch].

    Schoolbook columns in int64 (no lo/hi split needed: a column holds at
    most T L (2^16 - 1)^2 < 2^40), then the 16-bit-digit reduction."""
    T = a.shape[0]
    batch = torch.broadcast_shapes(a.shape[2:], b.shape[2:])
    a64, b64 = a.long(), b.long()
    prod = None
    for t in range(T):
        term = a64[t].unsqueeze(1) * b64[t].unsqueeze(0)  # [L, L, *batch]
        prod = term if prod is None else prod + term
    ids = limbs._const_tensor(
        tuple(i + j for i in range(L) for j in range(L)), a.device,
        torch.int64)
    cols = torch.zeros((2 * L + 1,) + batch, dtype=torch.int64,
                       device=a.device)
    cols.index_add_(0, ids, prod.reshape((L * L,) + batch))
    return _mont_reduce_plain(cols).to(limbs.DTYPE)


def sqr_plain(a: torch.Tensor) -> torch.Tensor:
    """G independent Montgomery squares, [G, L, *batch] -> [G, L, *batch]."""
    x = a.transpose(0, 1).unsqueeze(0)  # [1, L, G, *batch]
    return sop_plain(x, x).transpose(0, 1)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def sop(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fused (sum_t a[t] b[t]) R^-1 mod p: int32 [T, L, B] x2 -> [L, B]."""
    _check_limbs(a, "sop a")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"sop: operands differ: {tuple(a.shape)} on "
                         f"{a.device} vs {tuple(b.shape)} on {b.device}")
    T, _, B = a.shape
    if not 1 <= T <= MAX_TERMS:
        raise ValueError(f"sop: {T} terms; the kernel takes 1..{MAX_TERMS}")
    if device_kind(a) == "cpu":
        return sop_plain(a, b)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((L, B), dtype=limbs.DTYPE, device=a.device)
    if B == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _lib().bls_sop(a.data_ptr(), b.data_ptr(), out.data_ptr(), T, B,
                            stream)
        LAUNCHES.sop += 1
    check_launch(rc, "sop")
    return out


def sqr(a: torch.Tensor) -> torch.Tensor:
    """G independent Montgomery squares: int32 [G, L, B] -> [G, L, B]."""
    _check_limbs(a, "sqr")
    G, _, B = a.shape
    if device_kind(a) == "cpu":
        return sqr_plain(a)
    a = a.contiguous()
    out = torch.empty_like(a)
    if G * B == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _lib().bls_sqr(a.data_ptr(), out.data_ptr(), G, B, stream)
        LAUNCHES.sqr += 1
    check_launch(rc, "sqr")
    return out
