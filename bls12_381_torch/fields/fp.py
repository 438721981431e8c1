"""Batched base field Fp (381-bit): 24 16-bit limbs, Montgomery R = 2^384.

Counterpart of `bls12_381_tpu/fields/fp.py` (the main path's subset): the
`limbs` operations bound to the Fp spec, and the inversion."""

from __future__ import annotations

from functools import partial

from .. import limbs
from ..limbs import FP

add = partial(limbs.add, FP)
sub = partial(limbs.sub, FP)
neg = partial(limbs.neg, FP)
mul = partial(limbs.mont_mul, FP)
sqr = partial(limbs.mont_sqr, FP)
sop = partial(limbs.sum_of_products, FP)
sop_fold = partial(limbs.sop_fold, FP)
mul_many = partial(limbs.mul_many, FP)
add_many = partial(limbs.add_many, FP)
sub_many = partial(limbs.sub_many, FP)
neg_many = partial(limbs.neg_many, FP)
select = limbs.select
is_zero = limbs.is_zero
eq = limbs.eq

zero = partial(limbs.zero, FP)
one = partial(limbs.one, FP)
const = partial(limbs.const, FP)
from_ints = partial(limbs.from_ints, FP)
to_ints = partial(limbs.to_ints, FP)


def inv(a):
    """a^(p-2); 0 maps to 0 (fp.rs:346 returns a CtOption; callers mask)."""
    return limbs.inv(FP, a)


def batch_inv(a):
    """Elementwise inverse amortized over the last batch axis (one `inv`
    for the whole axis, g1.rs:806-839); zeros invert to zero."""
    return limbs.batch_inv(FP, a)
