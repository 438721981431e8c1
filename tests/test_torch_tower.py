"""The port's extension tower (bls12_381_torch.fields.tower) on the CPU
against the JAX package's RELIC-validated host oracle
`bls12_381_tpu.hostmath`.

Tolerance: none (integer arithmetic) -- every comparison is exact equality
of field elements.  Inputs are seeded random elements plus 0 / 1 edge
lanes; the Fp12 products run through the plain executor of the same
expression plans the card runs.
"""

import random

import pytest
import torch

import conftest  # noqa: F401
from bls12_381_tpu import hostmath as hm

from bls12_381_torch.fields import tower as tw
from bls12_381_torch.params import P

torch.set_num_threads(1)
rng = random.Random(77)


def r2():
    return (rng.randrange(P), rng.randrange(P))


def r6():
    return (r2(), r2(), r2())


def r12():
    return (r6(), r6())


# --- batched host <-> port codecs over lists of host elements --------------


def enc2(xs):
    return tw.fp2_from_ints(list(xs), device="cpu")


def enc6(xs):
    return tuple(enc2([x[i] for x in xs]) for i in range(3))


def enc12(xs):
    return tuple(enc6([x[i] for x in xs]) for i in range(2))


def dec2(a, i):
    return (int(tw.fp2_to_ints(a)[0][i]), int(tw.fp2_to_ints(a)[1][i]))


def dec6(a, i):
    return tuple(dec2(c, i) for c in a)


def dec12(a, i):
    return tuple(dec6(c, i) for c in a)


ONE2, ZERO2 = (1, 0), (0, 0)
X2 = [ONE2, (P - 1, P - 1), r2(), r2()]
Y2 = [(P - 1, 1), r2(), ONE2, r2()]
X6 = [(ONE2, ZERO2, ZERO2), r6(), r6()]
Y6 = [r6(), (ZERO2, ONE2, ZERO2), r6()]
X12 = [hm.FP12_ONE, r12(), r12()]
Y12 = [r12(), r12(), hm.FP12_ONE]


@pytest.mark.parametrize("op", ["mul", "sqr", "inv", "nonresidue",
                                "conjugate", "add", "sub", "neg"])
def test_fp2_ops(op):
    a, b = enc2(X2), enc2(Y2)
    port, host = {
        "mul": (lambda: tw.fp2_mul(a, b), lambda x, y: hm.fp2_mul(x, y)),
        "sqr": (lambda: tw.fp2_sqr(a), lambda x, y: hm.fp2_square(x)),
        "inv": (lambda: tw.fp2_inv(a), lambda x, y: hm.fp2_inv(x)),
        "nonresidue": (lambda: tw.fp2_mul_by_nonresidue(a),
                       lambda x, y: hm.fp2_mul_by_nonresidue(x)),
        "conjugate": (lambda: tw.fp2_conjugate(a),
                      lambda x, y: hm.fp2_conjugate(x)),
        "add": (lambda: tw.fp2_add(a, b), lambda x, y: hm.fp2_add(x, y)),
        "sub": (lambda: tw.fp2_sub(a, b), lambda x, y: hm.fp2_sub(x, y)),
        "neg": (lambda: tw.fp2_neg(a), lambda x, y: hm.fp2_neg(x)),
    }[op]
    got = port()
    for i, (x, y) in enumerate(zip(X2, Y2)):
        assert dec2(got, i) == host(x, y), i


def test_fp2_many():
    a, b = enc2(X2), enc2(Y2)
    s1, s2 = tw.fp2_mul_many([(a, b), (b, a)])
    d1, = tw.fp2_sub_many([(a, b)])
    e1, = tw.fp2_add_many([(a, b)])
    for i, (x, y) in enumerate(zip(X2, Y2)):
        assert dec2(s1, i) == dec2(s2, i) == hm.fp2_mul(x, y)
        assert dec2(d1, i) == hm.fp2_sub(x, y)
        assert dec2(e1, i) == hm.fp2_add(x, y)


@pytest.mark.parametrize("op", ["mul", "sqr", "inv", "frobenius",
                                "nonresidue", "add", "sub", "neg"])
def test_fp6_ops(op):
    a, b = enc6(X6), enc6(Y6)
    port, host = {
        "mul": (lambda: tw.fp6_mul(a, b), lambda x, y: hm.fp6_mul(x, y)),
        "sqr": (lambda: tw.fp6_sqr(a), lambda x, y: hm.fp6_square(x)),
        "inv": (lambda: tw.fp6_inv(a), lambda x, y: hm.fp6_inv(x)),
        "frobenius": (lambda: tw.fp6_frobenius(a),
                      lambda x, y: hm.fp6_frobenius(x)),
        "nonresidue": (lambda: tw.fp6_mul_by_nonresidue(a),
                       lambda x, y: hm.fp6_mul_by_nonresidue(x)),
        "add": (lambda: tw.fp6_add(a, b), lambda x, y: hm.fp6_add(x, y)),
        "sub": (lambda: tw.fp6_sub(a, b), lambda x, y: hm.fp6_sub(x, y)),
        "neg": (lambda: tw.fp6_neg(a), lambda x, y: hm.fp6_neg(x)),
    }[op]
    got = port()
    for i, (x, y) in enumerate(zip(X6, Y6)):
        assert dec6(got, i) == host(x, y), i


@pytest.mark.parametrize("op", ["mul", "sqr", "inv", "frobenius",
                                "conjugate"])
def test_fp12_ops(op):
    a, b = enc12(X12), enc12(Y12)
    port, host = {
        "mul": (lambda: tw.fp12_mul(a, b), lambda x, y: hm.fp12_mul(x, y)),
        "sqr": (lambda: tw.fp12_sqr(a), lambda x, y: hm.fp12_square(x)),
        "inv": (lambda: tw.fp12_inv(a), lambda x, y: hm.fp12_inv(x)),
        "frobenius": (lambda: tw.fp12_frobenius(a),
                      lambda x, y: hm.fp12_frobenius(x)),
        "conjugate": (lambda: tw.fp12_conjugate(a),
                      lambda x, y: hm.fp12_conjugate(x)),
    }[op]
    got = port()
    for i, (x, y) in enumerate(zip(X12, Y12)):
        assert dec12(got, i) == host(x, y), i


def test_fp12_sparse_line_multiplies():
    """f * line and f^2 * line for D-twist 045 lines (g0, g4, g5)."""
    g0, g4, g5 = [r2(), ONE2, r2()], [r2(), r2(), ZERO2], [r2(), r2(), r2()]
    f = enc12(X12)
    lines = enc2(g0), enc2(g4), enc2(g5)
    got = tw.fp12_mul_by_045(f, *lines)
    got_sq = tw.fp12_sqr_mul_by_045(f, *lines)
    for i, x in enumerate(X12):
        line = hm._sparse_line_045(g0[i], g4[i], g5[i])
        assert dec12(got, i) == hm.fp12_mul(x, line), i
        assert dec12(got_sq, i) == hm.fp12_mul(hm.fp12_square(x), line), i


@pytest.mark.parametrize("k", [1, 4])
def test_cyclotomic_sqr_k(k):
    """k chained Granger-Scott squarings equal k full squarings on an
    element of the cyclotomic subgroup."""
    f = r12()
    f = hm.fp12_mul(hm.fp12_conjugate(f), hm.fp12_inv(f))
    f = hm.fp12_mul(hm.fp12_frobenius(hm.fp12_frobenius(f)), f)
    got = tw.fp12_cyclotomic_sqr_k(tw.fp12_from_host(f, (2,), device="cpu"),
                                   k)
    exp = f
    for _ in range(k):
        exp = hm.fp12_square(exp)
    assert dec12(got, 0) == dec12(got, 1) == exp
