"""Batched G1: E(Fp): y^2 = x^3 + 4 (reference src/g1.rs), counterpart of
`bls12_381_tpu/curves/g1.py` without the byte codecs.

Points are tuples of Fp limb tensors [24, *batch]: projective (x, y, z),
affine (x, y, inf_mask).  Scalars are Montgomery Fr limb tensors
[16, *batch].
"""

from __future__ import annotations

import torch

from .. import hostmath as hm
from .. import limbs, params
from ..fields import fp
from ..kernels import plan_exec as pe
from .weierstrass import FieldFns, Weierstrass

_FNS = FieldFns(
    add=fp.add,
    neg=fp.neg,
    mul=fp.mul,
    mul_many=fp.mul_many,
    select=fp.select,
    eq=fp.eq,
    is_zero=fp.is_zero,
    zero=lambda batch, device: fp.zero(batch, device=device),
    one=lambda batch, device: fp.one(batch, device=device),
    b=lambda batch, device: fp.const(params.B_G1, batch, device=device),
    batch_of=lambda x: x.shape[1:],
    device_of=lambda x: x.device,
    rows=lambda x: [x],
    from_rows=lambda rows: rows[0],
    add_plan=pe.g1_add_plan,
    double_plan=pe.g1_double_plan,
    add_mixed_plan=pe.g1_add_mixed_plan,
)

CURVE = Weierstrass(_FNS)

identity = CURVE.identity
from_affine = CURVE.from_affine
is_identity = CURVE.is_identity
is_on_curve = CURVE.is_on_curve
eq = CURVE.eq
neg = CURVE.neg
double = CURVE.double
add = CURVE.add
add_mixed = CURVE.add_mixed

# endomorphism constant: cube root of unity with phi(P) = -[z^2]P (g1.rs:421)
BETA = hm.G1_BETA


def generator(batch=(), device="cuda"):
    gx, gy = params.G1_GEN
    return (fp.const(gx, batch, device=device),
            fp.const(gy, batch, device=device), fp.one(batch, device=device))


def generator_affine(batch=(), device="cuda"):
    gx, gy = params.G1_GEN
    return (fp.const(gx, batch, device=device),
            fp.const(gy, batch, device=device),
            torch.zeros(tuple(batch), dtype=torch.bool, device=device))


def _phi_x(p):
    """beta x: the endomorphism phi(x : y : z) = (beta x : y : z)."""
    return fp.mul(fp.const(BETA, p[0].shape[1:], device=p[0].device), p[0])


def scalar_mul(p, scalars_mont):
    """[s]P by the GLV split: phi acts as [-z^2] on the subgroup
    (g1.rs:401-410), so s = k1 + k2 z^2 with k1, k2 < 2^128 gives
    [s]P = [k1]P + [k2](beta x : -y : z), two 128-bit balanced-digit
    scalars with shared doublings.  Subgroup points only; use
    scalar_mul_generic for any curve point."""
    canon = limbs.from_mont(limbs.FR, scalars_mont)
    k2, k1 = limbs.barrett_divmod(canon, params.BLS_X ** 2, 9)
    p2 = (_phi_x(p), fp.neg(p[1]), p[2])  # [z^2]P = -phi(P)
    return CURVE.multi_scalar_mul_signed(
        [p, p2], [limbs.signed_digits_msb(k1, 128),
                  limbs.signed_digits_msb(k2, 128)])


def scalar_mul_generic(p, scalars_mont):
    """[s]P by plain 4-bit windows over the canonical s < q (g1.rs:754-774
    semantics; any curve point)."""
    return CURVE.scalar_mul_windowed(p, fr_digits4_msb(scalars_mont))


def fr_bits_msb(scalars_mont):
    """Montgomery Fr [16, *batch] -> [255, *batch] bool bits, MSB first."""
    canon = limbs.from_mont(limbs.FR, scalars_mont).long()
    return torch.stack([((canon[j // 16] >> (j % 16)) & 1) != 0
                        for j in range(254, -1, -1)])


def fr_digits4_msb(scalars_mont):
    """Montgomery Fr [16, *batch] -> [64, *batch] int32 4-bit digits, MSB
    first."""
    return limbs.digits4_msb(limbs.from_mont(limbs.FR, scalars_mont), 256)


def mul_by_x(p):
    """[|z|]P by the static bits of |z| (g1.rs:777-795; callers handle the
    sign)."""
    return CURVE.mul_by_const(p, params.BLS_X)


def clear_cofactor(p):
    """[1 - z]P = [1 + |z|]P (ia.cr/2019/403; g1.rs:800-802)."""
    return CURVE.mul_by_const(p, params.H_EFF_G1)


def is_torsion_free(p):
    """phi(P) == -[z^2]P (ePrint 2021/1130 §6; g1.rs:401-410)."""
    zsq = mul_by_x(mul_by_x(p))
    return CURVE.eq((_phi_x(p), p[1], p[2]), CURVE.neg(zsq))


def to_affine(p):
    """Projective -> affine, the z inversion amortized over the last batch
    axis (`fp.batch_inv`; the reference's batch_normalize, g1.rs:806-839)."""
    return CURVE.to_affine(p, fp.batch_inv)


batch_normalize = to_affine
