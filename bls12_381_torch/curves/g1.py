"""Batched G1: E(Fp): y^2 = x^3 + 4 (reference src/g1.rs), counterpart of
`bls12_381_tpu/curves/g1.py` without the scalar multiplications, the
subgroup check and the byte codecs.

Points are tuples of Fp limb tensors [24, *batch]: projective (x, y, z),
affine (x, y, inf_mask).
"""

from __future__ import annotations

import torch

from .. import hostmath as hm
from .. import params
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


def to_affine(p):
    """Projective -> affine, the z inversion amortized over the last batch
    axis (`fp.batch_inv`; the reference's batch_normalize, g1.rs:806-839)."""
    return CURVE.to_affine(p, fp.batch_inv)


batch_normalize = to_affine
