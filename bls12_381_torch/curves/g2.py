"""Batched G2: E'(Fp2): y^2 = x^3 + 4(u + 1) (reference src/g2.rs),
counterpart of `bls12_381_tpu/curves/g2.py` without the scalar
multiplications, cofactor clearing, subgroup check and byte codecs.

Points are tuples of Fp2 elements (pairs of Fp limb tensors): projective
(x, y, z), affine (x, y, inf_mask).  A plan takes each Fp2 coordinate as
its (c0, c1) rows.
"""

from __future__ import annotations

import torch

from .. import hostmath as hm
from .. import params
from ..fields import tower as tw
from ..kernels import plan_exec as pe
from .weierstrass import FieldFns, Weierstrass

_FNS = FieldFns(
    add=tw.fp2_add,
    neg=tw.fp2_neg,
    mul=tw.fp2_mul,
    mul_many=tw.fp2_mul_many,
    select=tw.fp2_select,
    eq=tw.fp2_eq,
    is_zero=tw.fp2_is_zero,
    zero=tw.fp2_zero,
    one=tw.fp2_one,
    b=lambda batch, device: tw.fp2_const(params.B_G2, batch, device),
    batch_of=lambda x: x[0].shape[1:],
    device_of=lambda x: x[0].device,
    rows=lambda x: [x[0], x[1]],
    from_rows=lambda rows: (rows[0], rows[1]),
    add_plan=pe.g2_add_plan,
    double_plan=pe.g2_double_plan,
    add_mixed_plan=pe.g2_add_mixed_plan,
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


def generator(batch=(), device="cuda"):
    x, y = params.G2_GEN
    return (tw.fp2_const(x, batch, device), tw.fp2_const(y, batch, device),
            tw.fp2_one(batch, device))


def generator_affine(batch=(), device="cuda"):
    """The standard G2 generator, affine (x, y, infinity), broadcast over a
    batch shape."""
    x, y = params.G2_GEN
    return (
        tw.fp2_const(x, batch, device),
        tw.fp2_const(y, batch, device),
        torch.zeros(tuple(batch), dtype=torch.bool, device=device),
    )


def psi(p):
    """Untwist-Frobenius-twist (x : y : z) -> (c_x x^p : c_y y^p : z^p)
    (g2.rs:847-888); it acts as [z] on the subgroup."""
    x, y, z = p
    batch, dev = x[0].shape[1:], x[0].device
    cx = tw.fp2_const(hm.PSI_CX, batch, dev)
    cy = tw.fp2_const(hm.PSI_CY, batch, dev)
    return (tw.fp2_mul(tw.fp2_conjugate(x), cx),
            tw.fp2_mul(tw.fp2_conjugate(y), cy), tw.fp2_conjugate(z))


def to_affine(p):
    """Projective -> affine, the z inversion amortized over the last batch
    axis (`tw.fp2_batch_inv`, g2.rs:951-984 analog)."""
    return CURVE.to_affine(p, tw.fp2_batch_inv)


batch_normalize = to_affine
