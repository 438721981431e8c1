"""Batched extension tower Fp2 / Fp6 / Fp12 (the tower of the reference):

  Fp2  = Fp[u]/(u^2+1)            elements: (c0, c1) tuples of Fp tensors
  Fp6  = Fp2[v]/(v^3 - (u+1))     elements: (c0, c1, c2) tuples of Fp2
  Fp12 = Fp6[w]/(w^2 - v)         elements: (c0, c1) tuples of Fp6

Counterpart of `bls12_381_tpu/fields/tower.py` in its default
configuration.  An Fp2 power by a public exponent (`fp2_pow`, two in every
`fp2_sqrt`) is one launch of the Fp2 power kernel (`mont.fp2_pow_fixed`).
Every Fp12 multiplication-type operation runs as one
expression plan (`kernels/plan_exec.py`): the plan kernel on a CUDA tensor,
its plain version on a CPU tensor.  Fp2 and Fp6 products are folds of fused
Fp sums of products (`fp.sop_fold`: one `fold_planned` launch for two or
more groups, one `sop` for a single group) whose additive glue is batched
into few carry networks.  Results are canonical, so they equal the JAX package's values limb for limb whatever the grouping.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import hostmath as hm, params
from ..kernels import mont, plan_exec as pe
from . import fp

CYCLO_FUSE = 4  # cyclotomic squarings chained per plan launch in exp-by-|z|

# =========================================================================
# Fp2
# =========================================================================


def fp2_add(a, b):
    return tuple(fp.add_many([(a[0], b[0]), (a[1], b[1])]))


def fp2_sub(a, b):
    return tuple(fp.sub_many([(a[0], b[0]), (a[1], b[1])]))


def fp2_neg(a):
    return tuple(fp.neg_many([a[0], a[1]]))


def fp2_add_many(pairs):
    """K independent Fp2 additions in one carry network."""
    flat = fp.add_many([(a[i], b[i]) for a, b in pairs for i in range(2)])
    return [(flat[2 * k], flat[2 * k + 1]) for k in range(len(pairs))]


def fp2_sub_many(pairs):
    """K independent Fp2 subtractions in one borrow network."""
    flat = fp.sub_many([(a[i], b[i]) for a, b in pairs for i in range(2)])
    return [(flat[2 * k], flat[2 * k + 1]) for k in range(len(pairs))]


def _fp2_groups_many(term_sets):
    """Fp-level sop groups (c0 group, c1 group) of each sum
    sum_i [xi *]? (x_i * y_i) over Fp2, for a list of term sets of
    (x, y, use_xi):
      plain: c0 += x0 y0 + x1 (-y1)          c1 += x0 y1 + x1 y0
      xi:    c0 += x0 ym + x1 (-yp)          c1 += x0 yp + x1 ym
    with ym = y0 - y1, yp = y0 + y1.  The derived operands of all sets come
    from three batched networks (ym, yp, then every negation)."""
    terms = [t for s in term_sets for t in s]
    xi_ys = [y for _, y, use_xi in terms if use_xi]
    ym = fp.sub_many([(y[0], y[1]) for y in xi_ys]) if xi_ys else []
    yp = fp.add_many([(y[0], y[1]) for y in xi_ys]) if xi_ys else []
    plain_neg = [y[1] for _, y, use_xi in terms if not use_xi]
    negs = fp.neg_many(plain_neg + yp) if plain_neg or yp else []
    it_plain = iter(negs[:len(plain_neg)])
    it_xi = iter(zip(ym, yp, negs[len(plain_neg):]))
    out = []
    for s in term_sets:
        c0g, c1g = [], []
        for x, y, use_xi in s:
            if use_xi:
                m, p, np_ = next(it_xi)
                c0g += [(x[0], m), (x[1], np_)]
                c1g += [(x[0], p), (x[1], m)]
            else:
                c0g += [(x[0], y[0]), (x[1], next(it_plain))]
                c1g += [(x[0], y[1]), (x[1], y[0])]
        out.append((c0g, c1g))
    return out


def _fp2_sops(term_sets):
    """One fused Fp2 sum of products per term set, all in ONE fold."""
    groups = [g for pair in _fp2_groups_many(term_sets) for g in pair]
    flat = fp.sop_fold(groups)
    return [(flat[2 * k], flat[2 * k + 1]) for k in range(len(term_sets))]


def fp2_mul_many(pairs):
    """Independent Fp2 products folded into one launch; returns a list."""
    return _fp2_sops([[(a, b, False)] for a, b in pairs])


def fp2_mul(a, b):
    """(a0 b0 - a1 b1, a0 b1 + a1 b0) (fp2.rs:205-222)."""
    return fp2_mul_many([(a, b)])[0]


def fp2_mul_fp(a, s):
    """An Fp2 element times an Fp element: both products in one launch."""
    return tuple(fp.mul_many([(a[0], s), (a[1], s)]))


def fp2_sop(terms):
    """Fused sum of Fp2 products sum_i x_i y_i, one Montgomery reduction
    per output component (one launch); at most 4 terms (T <= 8 Fp
    products per component)."""
    if not 1 <= len(terms) <= 4:
        raise ValueError(f"fp2_sop takes 1 to 4 terms, got {len(terms)}")
    return _fp2_sops([[(x, y, False) for x, y in terms]])[0]


def fp2_sqr(a):
    """Complex squaring: ((a0+a1)(a0-a1), 2 a0 a1) (fp2.rs:182-203)."""
    s = fp.add(a[0], a[1])
    d = fp.sub(a[0], a[1])
    t0, t1 = fp.mul_many([(s, d), (a[0], a[1])])
    return (t0, fp.add(t1, t1))


def fp2_mul_by_nonresidue(a):
    """Multiply by u+1: (c0 - c1, c0 + c1) (fp2.rs:156-166)."""
    return (fp.sub(a[0], a[1]), fp.add(a[0], a[1]))


def fp2_conjugate(a):
    return (a[0], fp.neg(a[1]))


fp2_frobenius = fp2_conjugate  # a^p in Fp2


def fp2_inv(a):
    """1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2) (fp2.rs:300-319)."""
    ninv = fp.inv(fp.sop([(a[0], a[0]), (a[1], a[1])]))
    t0, t1 = fp.mul_many([(a[0], ninv), (a[1], ninv)])
    return (t0, fp.neg(t1))


def fp2_batch_inv(a):
    """fp2_inv with the Fp norm inversion amortized over the last batch
    axis (`fp.batch_inv`, g1.rs:806-839 analog); zero inverts to zero."""
    ninv = fp.batch_inv(fp.sop([(a[0], a[0]), (a[1], a[1])]))
    t0, t1 = fp.mul_many([(a[0], ninv), (a[1], ninv)])
    return (t0, fp.neg(t1))


def fp2_select(mask, a, b):
    return (fp.select(mask, a[0], b[0]), fp.select(mask, a[1], b[1]))


def fp2_is_zero(a):
    return fp.is_zero(a[0]) & fp.is_zero(a[1])


def fp2_eq(a, b):
    return fp.eq(a[0], b[0]) & fp.eq(a[1], b[1])


def fp2_zero(batch=(), device="cuda"):
    return (fp.zero(batch, device=device), fp.zero(batch, device=device))


def fp2_one(batch=(), device="cuda"):
    return (fp.one(batch, device=device), fp.zero(batch, device=device))


def fp2_const(c, batch=(), device="cuda"):
    """A host (c0, c1) integer pair as a broadcast constant."""
    return (fp.const(c[0], batch, device=device),
            fp.const(c[1], batch, device=device))


def fp2_lexicographically_largest(a):
    """c1-major lexicographic order (fp2.rs:171-180): both halves'
    canonical values from one product launch."""
    large = fp.lexicographically_largest(
        torch.stack(torch.broadcast_tensors(*a), 1))  # [2, *batch]
    return large[1] | (fp.is_zero(a[1]) & large[0])


def fp2_sgn0(a):
    """sgn0 for m = 2 (draft-16 §4.1; map_g2.rs:381-388): both halves'
    parities from one product launch."""
    s = fp.sgn0_mont(torch.stack(torch.broadcast_tensors(*a), 1)) != 0
    return s[0] | (fp.is_zero(a[0]) & s[1])


def fp2_pow(a, e: int):
    """a^e for a public exponent: ONE launch of the Fp2 power kernel
    (`mont.fp2_pow_fixed`) over the flattened batch; a CPU tensor takes its
    plain version, the JAX package's bit schedule (tower.py:287-309).  e = 0
    is one without a launch, as in the JAX package."""
    a0, a1 = torch.broadcast_tensors(*a)
    if e == 0:
        return fp2_one(a0.shape[1:], a0.device)
    c0, c1 = mont.fp2_pow_fixed(a0.reshape(fp.FP.n_limbs, -1),
                                a1.reshape(fp.FP.n_limbs, -1), e)
    return c0.reshape(a0.shape), c1.reshape(a0.shape)


def fp2_sqrt(a):
    """Square root in Fp2 with a fixed schedule (ePrint 2012/685 Alg. 9,
    the algorithm family of fp2.rs:245-295) and the JAX package's root
    choice: (root, ok).  Both branches run and are mask-selected; two
    `fp2_pow` launches."""
    batch, dev = a[0].shape[1:], a[0].device
    a1 = fp2_pow(a, (params.P - 3) // 4)
    alpha = fp2_mul(fp2_sqr(a1), a)
    x0 = fp2_mul(a1, a)
    # alpha == -1: root = u x0
    is_m1 = fp2_eq(alpha, fp2_const((params.P - 1, 0), batch, dev))
    root_m1 = (fp.neg(x0[1]), x0[0])
    # otherwise: root = (1 + alpha)^((p-1)/2) x0
    b = fp2_pow(fp2_add(fp2_one(batch, dev), alpha), (params.P - 1) // 2)
    root = fp2_select(is_m1, root_m1, fp2_mul(b, x0))
    root = fp2_select(fp2_is_zero(a), fp2_zero(batch, dev), root)
    return root, fp2_eq(fp2_sqr(root), a)


# =========================================================================
# Fp6
# =========================================================================


def _fp6_flat(a):
    return [c for f2 in a for c in f2]  # 6 Fp components


def _fp6_unflat(flat):
    return ((flat[0], flat[1]), (flat[2], flat[3]), (flat[4], flat[5]))


def fp6_add(a, b):
    return _fp6_unflat(fp.add_many(list(zip(_fp6_flat(a), _fp6_flat(b)))))


def fp6_sub(a, b):
    return _fp6_unflat(fp.sub_many(list(zip(_fp6_flat(a), _fp6_flat(b)))))


def fp6_neg(a):
    return _fp6_unflat(fp.neg_many(_fp6_flat(a)))


def _fp6_mul_sets(a, b):
    """The three Fp2 term sets of an Fp6 product (fp6.rs:195-274):
      c0 = a0 b0 + xi (a1 b2 + a2 b1)
      c1 = a0 b1 + a1 b0 + xi (a2 b2)
      c2 = a0 b2 + a1 b1 + a2 b0
    each one fused 6-term Fp group per output component."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    return [
        [(a0, b0, False), (a1, b2, True), (a2, b1, True)],
        [(a0, b1, False), (a1, b0, False), (a2, b2, True)],
        [(a0, b2, False), (a1, b1, False), (a2, b0, False)],
    ]


def fp6_mul_many(pairs):
    """Independent Fp6 products in ONE fold of 6 groups each."""
    flat = _fp2_sops([s for a, b in pairs for s in _fp6_mul_sets(a, b)])
    return [tuple(flat[3 * k:3 * k + 3]) for k in range(len(pairs))]


def fp6_mul(a, b):
    return fp6_mul_many([(a, b)])[0]


def fp6_sqr(a):
    return fp6_mul(a, a)


def fp6_mul_by_0(a, g0):
    """a * (g0 + 0 v + 0 v^2): three Fp2 products in one fold."""
    return tuple(fp2_mul_many([(a[0], g0), (a[1], g0), (a[2], g0)]))


def fp6_mul_by_12(a, g1, g2):
    """a * (g1 v + g2 v^2) in one fold:
      c0 = xi (a2 g1 + a1 g2)
      c1 = a0 g1 + xi (a2 g2)
      c2 = a1 g1 + a0 g2"""
    return tuple(_fp2_sops([
        [(a[2], g1, True), (a[1], g2, True)],
        [(a[0], g1, False), (a[2], g2, True)],
        [(a[1], g1, False), (a[0], g2, False)],
    ]))


def fp6_mul_by_nonresidue(a):
    """Multiply by v: (xi c2, c0, c1) (fp6.rs:139-150)."""
    return (fp2_mul_by_nonresidue(a[2]), a[0], a[1])


def fp6_inv(a):
    """Adjugate inversion with one Fp2 inversion (fp6.rs:294-312)."""
    a0, a1, a2 = a
    s0, s1, s2, m12, m01, m02 = fp2_mul_many(
        [(a0, a0), (a1, a1), (a2, a2), (a1, a2), (a0, a1), (a0, a2)])
    c0 = fp2_sub(s0, fp2_mul_by_nonresidue(m12))
    c1 = fp2_sub(fp2_mul_by_nonresidue(s2), m01)
    c2 = fp2_sub(s1, m02)
    u, v = _fp2_sops([[(a1, c2, False), (a2, c1, False)], [(a0, c0, False)]])
    tinv = fp2_inv(fp2_add(fp2_mul_by_nonresidue(u), v))
    return tuple(fp2_mul_many([(c0, tinv), (c1, tinv), (c2, tinv)]))


def fp6_select(mask, a, b):
    return tuple(fp2_select(mask, x, y) for x, y in zip(a, b))


def fp6_eq(a, b):
    return fp2_eq(a[0], b[0]) & fp2_eq(a[1], b[1]) & fp2_eq(a[2], b[2])


def fp6_zero(batch=(), device="cuda"):
    zero = fp2_zero(batch, device)
    return (zero, zero, zero)


def fp6_one(batch=(), device="cuda"):
    zero = fp2_zero(batch, device)
    return (fp2_one(batch, device), zero, zero)


def fp6_frobenius(a):
    """(c0^p, gamma1 c1^p, gamma2 c2^p), gamma_i = xi^(i(p-1)/3)
    (fp6.rs:152-188)."""
    batch, dev = a[0][0].shape[1:], a[0][0].device
    n0, n1, n2 = fp.neg_many([a[0][1], a[1][1], a[2][1]])
    c1, c2 = fp2_mul_many([
        ((a[1][0], n1), fp2_const(hm.FROB6_C1, batch, dev)),
        ((a[2][0], n2), fp2_const(hm.FROB6_C2, batch, dev)),
    ])
    return ((a[0][0], n0), c1, c2)


# =========================================================================
# Fp12 (products through expression plans)
# =========================================================================


def _unflatten12(o):
    return (_fp6_unflat(o[0:6]), _fp6_unflat(o[6:12]))


def _run_fp12_plan(plan, comps):
    return _unflatten12(pe.run_plan(plan, comps))


def _f12_rows(a):
    return _fp6_flat(a[0]) + _fp6_flat(a[1])


def fp12_add(a, b):
    """Component-wise sum in one carry network."""
    return _unflatten12(fp.add_many(list(zip(_f12_rows(a), _f12_rows(b)))))


def fp12_mul(a, b):
    """Karatsuba over Fp6 (fp12.rs:197-213) as one plan."""
    return _run_fp12_plan(pe.fp12_mul_plan(), _f12_rows(a) + _f12_rows(b))


def fp12_sqr(a):
    """(c0 + c1 w)^2 (fp12.rs:174-185) as one plan."""
    return _run_fp12_plan(pe.fp12_sqr_plan(), _f12_rows(a))


def fp12_cyclotomic_sqr(f):
    """Granger-Scott squaring in the cyclotomic subgroup (ePrint 2009/565);
    valid only after the easy part of the final exponentiation."""
    return _run_fp12_plan(pe.fp12_cyclotomic_sqr_plan(), _f12_rows(f))


def fp12_cyclotomic_sqr_k(f, k: int):
    """k consecutive cyclotomic squarings as ONE plan launch."""
    if k == 1:
        return fp12_cyclotomic_sqr(f)
    return _run_fp12_plan(pe.fp12_cyclotomic_sqr_k_plan(k), _f12_rows(f))


def fp12_mul_by_045(f, g0, g4, g5):
    """f * (g0 + g4 (v w) + g5 (v^2 w)): the Miller line multiply in the
    D-twist 045 convention, as one plan."""
    return _run_fp12_plan(
        pe.fp12_mul_by_045_plan(),
        _f12_rows(f) + [g0[0], g0[1], g4[0], g4[1], g5[0], g5[1]])


def fp12_sqr_mul_by_045(f, g0, g4, g5):
    """f^2 * (g0 + g4 (v w) + g5 (v^2 w)): the Miller doubling-step update
    (pairings.rs:620-634 + ell), as one plan."""
    return _run_fp12_plan(
        pe.fp12_sqr_mul_by_045_plan(),
        _f12_rows(f) + [g0[0], g0[1], g4[0], g4[1], g5[0], g5[1]])


def fp12_conjugate(a):
    """a^(p^6) (fp12.rs:136)."""
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    """1/(c0 + c1 w) via the norm c0^2 - v c1^2 (fp12.rs:187-194)."""
    s0, s1 = fp6_mul_many([(a[0], a[0]), (a[1], a[1])])
    tinv = fp6_inv(fp6_sub(s0, fp6_mul_by_nonresidue(s1)))
    m0, m1 = fp6_mul_many([(a[0], tinv), (a[1], tinv)])
    return (m0, fp6_neg(m1))


def fp12_frobenius(a):
    """(c0^p, gamma12 c1^p), gamma12 = xi^((p-1)/6) (fp12.rs:145-171)."""
    batch, dev = a[0][0][0].shape[1:], a[0][0][0].device
    c0 = fp6_frobenius(a[0])
    g = fp2_const(hm.FROB12_C1, batch, dev)
    c1 = tuple(fp2_mul_many([(x, g) for x in fp6_frobenius(a[1])]))
    return (c0, c1)


def fp12_select(mask, a, b):
    return (fp6_select(mask, a[0], b[0]), fp6_select(mask, a[1], b[1]))


def fp12_eq(a, b):
    return fp6_eq(a[0], b[0]) & fp6_eq(a[1], b[1])


def fp12_zero(batch=(), device="cuda"):
    return (fp6_zero(batch, device), fp6_zero(batch, device))


def fp12_one(batch=(), device="cuda"):
    return (fp6_one(batch, device), fp6_zero(batch, device))


def fp12_pow(a, e: int):
    """a^e for a static e >= 0: MSB-first square-and-multiply from acc = a
    (tower.py:861-878 of the JAX package), one `fp12_sqr` plan per bit
    below the top and one `fp12_mul` plan at each set bit.  The JAX scan
    multiplies at every bit and selects; the values are the same."""
    if e == 0:
        return fp12_one(a[0][0][0].shape[1:], a[0][0][0].device)
    acc = a
    for bit in bin(e)[3:]:
        acc = fp12_sqr(acc)
        if bit == "1":
            acc = fp12_mul(acc, a)
    return acc


# =========================================================================
# host <-> device codecs
# =========================================================================


def fp2_from_ints(vals, device="cuda"):
    """vals: a sequence of (c0, c1) int pairs (or a single pair)."""
    arr = np.asarray(vals, dtype=object)
    if arr.ndim == 1:
        return (fp.from_ints(arr[0], device=device),
                fp.from_ints(arr[1], device=device))
    return (fp.from_ints(list(arr[..., 0]), device=device),
            fp.from_ints(list(arr[..., 1]), device=device))


def fp2_to_ints(a):
    return (fp.to_ints(a[0]), fp.to_ints(a[1]))


def fp12_from_host(h, batch=(), device="cuda"):
    """A host Fp12 (nested int tuples) as a broadcast constant."""
    return tuple(tuple(fp2_const(c2, batch, device) for c2 in c6)
                 for c6 in h)


def fp12_to_host(a):
    """A device Fp12 batch as nested tuples whose leaves are numpy object
    arrays over the batch (ints for an empty batch shape)."""
    return tuple(tuple((fp.to_ints(c2[0]), fp.to_ints(c2[1])) for c2 in c6)
                 for c6 in a)
