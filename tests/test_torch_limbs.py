"""The port's limb arithmetic (bls12_381_torch.limbs, kernels/mont.py plain
versions) against the JAX package's jnp path and Pallas kernels on the CPU.

Tolerance: none (integer arithmetic) -- every comparison is exact equality
of 16-bit limbs.  Inputs come from a seeded generator plus the edge values
0, 1 and p-1; data crosses between the packages as numpy via
bls12_381_torch.convert.
"""

import random

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax.numpy as jnp
from bls12_381_tpu import limbs as jlb
from bls12_381_tpu.fields import fp as jfp
from bls12_381_tpu.kernels import pallas_mont

from bls12_381_torch import convert, limbs
from bls12_381_torch.fields import fp
from bls12_381_torch.kernels import mont
from bls12_381_torch.params import P

torch.set_num_threads(1)
R = 1 << 384
RINV = pow(R, -1, P)
rng = random.Random(1234)
EDGES = [0, 1, P - 1]


def rvals(n):
    return EDGES + [rng.randrange(P) for _ in range(n - len(EDGES))]


def both(vals):
    """(JAX array, port tensor) of the same Montgomery-encoded values."""
    j = jfp.from_ints(vals)
    return j, convert.fp_to_torch(np.asarray(j), "cpu")


def same(port, jax_arr):
    return np.array_equal(convert.fp_from_torch(port), np.asarray(jax_arr))


A_VALS = rvals(12)
B_VALS = [P - 1, 0, P - 1] + rvals(12)[3:]


def test_codecs_match_jax():
    ja, ta = both(A_VALS)
    assert same(fp.from_ints(A_VALS, device="cpu"), ja)
    assert [int(v) for v in fp.to_ints(ta)] == A_VALS
    raw = fp.from_ints(A_VALS, to_mont=False, device="cpu")
    assert same(raw, jfp.from_ints(A_VALS, to_mont=False))
    assert fp.to_ints(fp.const(5, (3,), device="cpu"))[2] == 5
    assert same(fp.one((4,), device="cpu"), jfp.one((4,)))


@pytest.mark.parametrize("op", ["add", "sub", "neg", "double"])
def test_additive_ops_match_jax(op):
    ja, ta = both(A_VALS)
    jb, tb = both(B_VALS)
    if op == "neg":
        assert same(limbs.neg(limbs.FP, ta), jlb.neg(jlb.FP, ja))
    elif op == "double":
        assert same(limbs.double(limbs.FP, ta), jlb.double(jlb.FP, ja))
    else:
        port = getattr(limbs, op)(limbs.FP, ta, tb)
        assert same(port, getattr(jlb, op)(jlb.FP, ja, jb))
        # every pair of edge values, both orders
        ge = [x for x in EDGES for _ in EDGES]
        he = [y for _ in EDGES for y in EDGES]
        jx, tx = both(ge)
        jy, ty = both(he)
        assert same(getattr(limbs, op)(limbs.FP, tx, ty),
                    getattr(jlb, op)(jlb.FP, jx, jy))


def test_add_many_sub_many_neg_many():
    ja, ta = both(A_VALS)
    jb, tb = both(B_VALS)
    jpairs = [(ja, jb), (jb, ja), (ja, ja)]
    tpairs = [(ta, tb), (tb, ta), (ta, ta)]
    for port_fn, jax_fn in ((limbs.add_many, jlb.add_many),
                            (limbs.sub_many, jlb.sub_many)):
        got = port_fn(limbs.FP, tpairs)
        exp = jax_fn(jlb.FP, jpairs)
        assert all(same(g, e) for g, e in zip(got, exp))
    negs = limbs.neg_many(limbs.FP, [ta, tb])
    assert same(negs[0], jlb.neg(jlb.FP, ja))
    assert same(negs[1], jlb.neg(jlb.FP, jb))


@pytest.mark.parametrize("T", [1, 2, 3, 4, 5, 6, 7, 8, 11])
def test_sum_of_products_matches_jax(T):
    """T <= 8 is one fused kernel call; T = 11 is chunked (8 + 3) and the
    partials added, as in the JAX package."""
    pairs_j, pairs_t = [], []
    for _ in range(T):
        ja, ta = both(rvals(10))
        jb, tb = both(rvals(10))
        pairs_j.append((ja, jb))
        pairs_t.append((ta, tb))
    got = limbs.sum_of_products(limbs.FP, pairs_t)
    assert same(got, jlb.sum_of_products(jlb.FP, pairs_j))


def test_sop_edge_rows_exact():
    """Carry edge cases against Python integers: every operand p-1 with
    T = 8 (the largest pre-reduction value), and 0 / 1 / p-1 mixes."""
    raw = [[P - 1] * 4, [0, 1, P - 1, 1], [P - 1, P - 1, 0, 1]]
    for T in (1, 8):
        a_rows = [[v for v in raw[(t + 0) % 3]] for t in range(T)]
        b_rows = [[v for v in raw[(t + 2) % 3]] for t in range(T)]
        if T == 8:
            a_rows = b_rows = [[P - 1] * 4 for _ in range(T)]
        a = torch.stack([fp.from_ints(r, to_mont=False, device="cpu")
                         for r in a_rows])
        b = torch.stack([fp.from_ints(r, to_mont=False, device="cpu")
                         for r in b_rows])
        got = fp.to_ints(mont.sop(a, b), from_mont=False)
        for lane in range(4):
            exp = sum(a_rows[t][lane] * b_rows[t][lane]
                      for t in range(T)) * RINV % P
            assert int(got[lane]) == exp


def test_mont_mul_sqr_fold_match_jax():
    ja, ta = both(A_VALS)
    jb, tb = both(B_VALS)
    assert same(limbs.mont_mul(limbs.FP, ta, tb), jlb.mont_mul(jlb.FP, ja, jb))
    assert same(limbs.mont_sqr(limbs.FP, ta), jlb.mont_sqr(jlb.FP, ja))
    groups_t = [[(ta, tb), (tb, tb)], [(ta, ta)], [(tb, ta), (ta, tb),
                                                  (ta, ta)]]
    groups_j = [[(ja, jb), (jb, jb)], [(ja, ja)], [(jb, ja), (ja, jb),
                                                  (ja, ja)]]
    for g, e in zip(limbs.sop_fold(limbs.FP, groups_t),
                    jlb.sop_fold(jlb.FP, groups_j)):
        assert same(g, e)
    for g, e in zip(limbs.mul_many(limbs.FP, [(ta, tb), (tb, tb)]),
                    jlb.mul_many(jlb.FP, [(ja, jb), (jb, jb)])):
        assert same(g, e)


def test_pow_fixed_and_inv_match_jax():
    ja, ta = both(A_VALS[:6])
    assert same(limbs.pow_fixed(limbs.FP, ta, 0x1234567),
                jlb.pow_fixed(jlb.FP, ja, 0x1234567))
    inv = fp.inv(ta)
    assert same(inv, jfp.inv(ja))
    vals = [int(v) for v in fp.to_ints(inv)]
    assert vals[0] == 0  # 0 maps to 0
    assert all(v * x % P == 1 for v, x in zip(vals[1:], A_VALS[1:6]))


def test_predicates_and_select_match_jax():
    ja, ta = both(A_VALS)
    jb, tb = both(B_VALS)
    assert np.array_equal(limbs.is_zero(ta).numpy(),
                          np.asarray(jlb.is_zero(ja)))
    assert np.array_equal(limbs.eq(ta, tb).numpy(),
                          np.asarray(jlb.eq(ja, jb)))
    mask_np = np.array([i % 3 == 0 for i in range(len(A_VALS))])
    assert same(limbs.select(torch.from_numpy(mask_np), ta, tb),
                jlb.select(jnp.asarray(mask_np), ja, jb))


def _pallas_kw():
    return dict(n_limbs=jlb.FP.n_limbs, inv16=jlb.FP.inv16,
                p_limbs=tuple(int(x) for x in jlb.FP.p_limbs), block_b=32,
                interpret=True, version=4)


def test_plain_sop_matches_pallas_interpret():
    """The plain sop (the kernel's CPU version) against sop_pallas run in
    interpret mode (vectorized version 4: the per-limb version 3 compiles
    too slowly under XLA CPU interpret)."""
    T, nb = 3, 8
    a_np = np.stack([np.asarray(jfp.from_ints(rvals(nb))) for _ in range(T)])
    b_np = np.stack([np.asarray(jfp.from_ints(rvals(nb))) for _ in range(T)])
    exp = pallas_mont.sop_pallas(jnp.asarray(a_np), jnp.asarray(b_np),
                                 **_pallas_kw())
    got = mont.sop_plain(convert.fp_to_torch(a_np, "cpu"),
                         convert.fp_to_torch(b_np, "cpu"))
    assert same(got, exp)


def test_plain_sqr_matches_pallas_interpret():
    vals = [0, 1, P - 1, P - 2] + rvals(8)[3:]
    a_np = np.asarray(jfp.from_ints(vals))[None]
    exp = pallas_mont.sqr_pallas(jnp.asarray(a_np), **_pallas_kw())
    got = mont.sqr(convert.fp_to_torch(a_np, "cpu"))
    assert np.array_equal(convert.fp_from_torch(got), np.asarray(exp))
    assert [int(v) for v in fp.to_ints(got[0])] == [x * x % P for x in vals]


def test_wrappers_validate_inputs():
    x = torch.zeros((9, 24, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        mont.sop(x, x)  # T = 9 > 8
    with pytest.raises(ValueError):
        mont.sop(x[:2, :20], x[:2, :20])  # not 24 limbs
    with pytest.raises(ValueError):
        mont.sqr(x.long())
