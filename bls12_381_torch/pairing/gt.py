"""Gt, the pairing's target group, written additively (pairings.rs:204-337);
counterpart of `bls12_381_tpu/pairing/gt.py`.

Elements are Fp12 values of order q (the cyclotomic subgroup), batched like
every other field element:

    add    = Fp12 multiplication       (pairings.rs:266-272)
    neg    = conjugation, the unitary inverse (pairings.rs:260-263)
    double = cyclotomic squaring
    scalar = the 4-way GLS split over shared cyclotomic doublings, or the
             reference's 255-step ladder (pairings.rs:304-322)

Each product and squaring is one plan launch (`fields/tower.py`).
"""

from __future__ import annotations

from .. import hostmath as hm
from .. import limbs, params
from ..fields import tower as tw
from ..utils import scans

identity = tw.fp12_one
add = tw.fp12_mul
neg = tw.fp12_conjugate
double = tw.fp12_cyclotomic_sqr
eq = tw.fp12_eq
select = tw.fp12_select
frobenius = tw.fp12_frobenius  # acts as [p] = [z] on the order-q subgroup

WINDOW = 4  # bits per Straus window of scalar_mul


def sub(a, b):
    return add(a, neg(b))


def generator(batch_shape=(), device="cuda"):
    """e(G1, G2), the fixed generator (pairings.rs:359-475), computed once
    on the host and broadcast over a batch shape (expanded views)."""
    return tw.fp12_from_host(hm.gt_generator(), batch_shape, device)


def is_identity(a):
    leaf = a[0][0][0]
    return eq(a, identity(leaf.shape[1:], leaf.device))


def _broadcast_to_batch(a, batch):
    """Expand every leaf [L] or [L, *batch] to [L, *batch] (views, no
    copy)."""
    full = tuple(batch)
    return scans.tree_map(lambda t: t.reshape(
        t.shape + (1,) * (1 + len(full) - t.dim())).expand(
        (t.shape[0],) + full), a)


def scalar_mul(gt, scalars_mont):
    """[k]a for Gt elements a = `gt` and Montgomery Fr scalars [16, *batch]
    by the 4-way GLS split: the Frobenius acts as [z] on the order-q
    subgroup, as psi does on G2, so k = c0 + c1|z| + c2|z|^2 + c3|z|^3
    (three Barrett divisions) gives [k]a = [c0]a + [c1](-frob a)
    + [c2]frob^2 a + [c3](-frob^3 a): four 64-bit scalars, 64 doublings
    instead of 255.
    Elements of Gt only; scalar_mul_generic otherwise."""
    canon = limbs.from_mont(limbs.FR, scalars_mont)
    batch = canon.shape[1:]
    a = _broadcast_to_batch(gt, batch)
    x = params.BLS_X
    q3, r3 = limbs.barrett_divmod(canon, x ** 3, 5)
    q2, r2 = limbs.barrett_divmod(r3, x ** 2, 5)
    q1, c0 = limbs.barrett_divmod(r2, x, 5)
    fa = frobenius(a)
    f3 = frobenius(fa)                   # [|z|^2] a
    elems = [a, neg(fa), f3, neg(frobenius(f3))]
    # Straus windows over 4-bit digits, the WINDOW doublings of a step as
    # ONE chained plan launch: its outputs are canonical, so they equal the
    # JAX package's WINDOW single squarings
    return scans.straus(
        elems, [(limbs.digits4_msb(k, 64), None) for k in (c0, q1, q2, q3)],
        1 << WINDOW, lambda: identity(batch, canon.device), add,
        lambda acc: tw.fp12_cyclotomic_sqr_k(acc, WINDOW))


def scalar_mul_generic(gt, scalars_mont):
    """[k]a, a = `gt`, by the reference's ladder (pairings.rs:304-322): from
    the identity, 255 steps over the canonical scalar's bits, MSB first,
    each a doubling, an add and a select."""
    canon = limbs.from_mont(limbs.FR, scalars_mont).long()
    batch = canon.shape[1:]
    a = _broadcast_to_batch(gt, batch)
    acc = identity(batch, canon.device)
    for i in range(254, -1, -1):
        acc = double(acc)
        bit = ((canon[i // 16] >> (i % 16)) & 1) != 0
        acc = select(bit, add(acc, a), acc)
    return acc
