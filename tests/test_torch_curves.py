"""The port's group law (bls12_381_torch.curves, the group-law plans of
kernels/plan_exec.py through their plain executor), batch inversions and
scans against the JAX package on the CPU and its host oracle.

Tolerance: none (integer arithmetic) -- points compare limb for limb in
projective coordinates: the plans and the JAX package's staged formulas
compute the same canonical values.  Inputs are seeded multiples of the
generators in random projective scalings, with identity lanes, a point
added to itself and a point added to its negation.
"""

import random

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax
import jax.numpy as jnp
from bls12_381_tpu import hostmath as jhm
from bls12_381_tpu.curves import g1 as jg1, g2 as jg2
from bls12_381_tpu.fields import fp as jfp, tower as jtw

from bls12_381_torch import convert, hostmath as hm
from bls12_381_torch.curves import g1, g2
from bls12_381_torch.fields import fp, tower as tw
from bls12_381_torch.kernels import plan_exec as pe
from bls12_381_torch.params import G1_GEN, G2_GEN, P, Q
from bls12_381_torch.utils import scans

torch.set_num_threads(1)
rng = random.Random(99)


def r2():
    return (rng.randrange(1, P), rng.randrange(P))


# --- host points in random projective scalings ----------------------------


def g1_proj(pt):
    """Host affine point (or None) -> (X, Y, Z) ints with a random Z."""
    if pt is None:
        return (0, 1, 0)
    lam = rng.randrange(1, P)
    return (pt[0] * lam % P, pt[1] * lam % P, lam)


def g2_proj(pt):
    if pt is None:
        return ((0, 0), (1, 0), (0, 0))
    lam = r2()
    return (jhm.fp2_mul(pt[0], lam), jhm.fp2_mul(pt[1], lam), lam)


def enc_g1(pts):
    """Projective int triples -> (JAX point, port point)."""
    j = tuple(jfp.from_ints([p[i] for p in pts]) for i in range(3))
    return j, convert.g1_proj_to_torch(tuple(np.asarray(c) for c in j), "cpu")


def enc_g2(pts):
    j = tuple(jtw.fp2_from_ints([p[i] for p in pts]) for i in range(3))
    return j, convert.g2_proj_to_torch(
        tuple(tuple(np.asarray(c) for c in f2) for f2 in j), "cpu")


def same_g1(port, jax_pt):
    return all(np.array_equal(a, np.asarray(b)) for a, b in
               zip(convert.g1_proj_from_torch(port), jax_pt))


def same_g2(port, jax_pt):
    return all(np.array_equal(a, np.asarray(b)) for pa, pb in
               zip(convert.g2_proj_from_torch(port), jax_pt)
               for a, b in zip(pa, pb))


GROUPS = {
    "g1": dict(mul=jhm.g1_mul, neg=jhm.g1_neg, gen=G1_GEN, proj=g1_proj,
               enc=enc_g1, same=same_g1, port=g1, jax=jg1, zero=0, one=1),
    "g2": dict(mul=jhm.g2_mul, neg=jhm.g2_neg, gen=G2_GEN, proj=g2_proj,
               enc=enc_g2, same=same_g2, port=g2, jax=jg2, zero=(0, 0),
               one=(1, 0)),
}


def lane_pairs(g):
    """Host (P, Q) pairs: generic, P + P in two scalings, P + (-P), with the
    identity on either side and on both."""
    a, b = (g["mul"](g["gen"], rng.randrange(1, 1 << 30)) for _ in range(2))
    c = g["mul"](g["gen"], rng.randrange(1, 1 << 30))
    return [(a, b), (c, c), (a, g["neg"](a)), (b, None), (None, c),
            (None, None), (b, a)]


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("op", ["add", "double", "add_mixed"])
def test_group_law_plans_match_jax(group, op):
    g = GROUPS[group]
    pairs = lane_pairs(g)
    jp, tp = g["enc"]([g["proj"](p) for p, _ in pairs])
    if op == "double":
        got, want = g["port"].double(tp), g["jax"].double(jp)
    elif op == "add":
        jq, tq = g["enc"]([g["proj"](q) for _, q in pairs])
        got, want = g["port"].add(tp, tq), g["jax"].add(jp, jq)
    else:
        # affine operand: (x, y, inf), the identity as (0, 1, True)
        z, o = g["zero"], g["one"]
        jq, tq = g["enc"]([(q[0], q[1], o) if q else (z, o, z)
                           for _, q in pairs])
        inf = np.array([q is None for _, q in pairs])
        got = g["port"].add_mixed(tp, (tq[0], tq[1], torch.from_numpy(inf)))
        want = g["jax"].add_mixed(jp, (jq[0], jq[1], jnp.asarray(inf)))
    assert g["same"](got, want)


def test_group_law_plan_names_and_shapes():
    for make in pe.GROUP_LAW_PLANS:
        plan = pe.compile_plan(make())
        assert plan.name == make.__name__
        n = 1 if make.__name__.startswith("g1") else 2
        n_in = {"add": 6, "double": 3, "add_mixed": 5}[
            make.__name__[3:-5]] * n
        assert (plan.n_in, plan.n_out) == (n_in, 3 * n)
        assert max(plan.sop_terms()) <= 6


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_predicates_and_to_affine_match_jax(group):
    g = GROUPS[group]
    pts = [g["mul"](g["gen"], rng.randrange(1, 1 << 30)) for _ in range(17)]
    pts[3] = pts[4] = None
    rows = [g["proj"](p) for p in pts]
    # an off-curve lane: y replaced
    rows[5] = (rows[5][0], rows[6][1], rows[5][2])
    jp, tp = g["enc"](rows)
    assert np.array_equal(g["port"].is_on_curve(tp).numpy(),
                          np.asarray(g["jax"].is_on_curve(jp)))
    assert not bool(g["port"].is_on_curve(tp)[5])
    # eq: the same points in other scalings, shifted by one lane
    jq, tq = g["enc"]([g["proj"](pts[(i + 1) % 17] if i % 2 else p)
                       for i, p in enumerate(pts)])
    got_eq = g["port"].eq(tp, tq).numpy()
    assert np.array_equal(got_eq, np.asarray(g["jax"].eq(jp, jq)))
    assert got_eq[0] and got_eq[3] and not got_eq[1]  # lane 3: two identities
    del rows[5], pts[5]
    jp, tp = g["enc"](rows)
    got = g["port"].to_affine(tp)
    want = g["jax"].to_affine(jp)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    if group == "g1":
        assert same_g1(got[:2] + (got[0],), want[:2] + (want[0],))
        assert [int(v) for v in fp.to_ints(got[0])][:3] == [
            pts[0][0], pts[1][0], pts[2][0]]
    else:
        assert same_g2(got[:2] + (got[0],), want[:2] + (want[0],))
        assert tuple(int(v[0]) for v in tw.fp2_to_ints(got[1])) == pts[0][1]
    assert bool(got[2][3]) and not bool(got[2][0])


def inverse_inputs(n):
    return ([0, 1, P - 1] + [rng.randrange(P) for _ in range(n - 3)],
            [(0, 0), (1, 0), (0, P - 1)] + [r2() for _ in range(n - 3)])


def test_batch_inverses_match_jax():
    """20 lanes: the prefix/suffix product scans with one inversion."""
    vals, vals2 = inverse_inputs(20)
    ja, jb = jfp.from_ints(vals), jtw.fp2_from_ints(vals2)
    got = fp.batch_inv(convert.fp_to_torch(np.asarray(ja), "cpu"))
    assert np.array_equal(convert.fp_from_torch(got),
                          np.asarray(jax.jit(jfp.batch_inv)(ja)))
    got2 = tw.fp2_batch_inv(convert.fp2_to_torch(
        tuple(np.asarray(c) for c in jb), "cpu"))
    for a, b in zip(convert.fp2_from_torch(got2),
                    jax.jit(jtw.fp2_batch_inv)(jb)):
        assert np.array_equal(a, np.asarray(b))
    assert tw.fp2_is_zero(got2).tolist() == [True] + [False] * 19


def test_batch_inverses_of_small_batches():
    """Below 16 lanes each lane is inverted on its own; zero maps to 0."""
    vals, vals2 = inverse_inputs(5)
    got = fp.to_ints(fp.batch_inv(fp.from_ints(vals, device="cpu")))
    assert [int(v) for v in got] == [pow(v, P - 2, P) for v in vals]
    x0, x1 = tw.fp2_to_ints(tw.fp2_batch_inv(
        tw.fp2_from_ints(vals2, device="cpu")))
    assert [(int(a), int(b)) for a, b in zip(x0, x1)] == [(0, 0)] + [
        jhm.fp2_inv(v) for v in vals2[1:]]


def test_psi_and_endomorphism_constants_match_jax():
    assert g1.BETA == jg1.BETA
    assert (hm.PSI_CX, hm.PSI_CY) == (jhm.PSI_CX, jhm.PSI_CY)
    pts = [jhm.g2_mul(G2_GEN, rng.randrange(1, 1 << 30)) for _ in range(3)]
    jp, tp = enc_g2([g2_proj(p) for p in pts] + [g2_proj(None)])
    assert same_g2(g2.psi(tp), jg2.psi(jp))



def test_port_hostmath_matches_jax_hostmath():
    """The port's host group law (the card checks' oracle,
    `tests/port_cases.py`) equals the JAX package's: multiples by full-width scalars, sums, P + P,
    P + (-P) and the identity."""
    ks = [0, 1, 3, 1 << 20, Q - 1] + [rng.randrange(Q) for _ in range(3)]
    for gen, mul, add, neg, jmul, jadd in (
            (G1_GEN, hm.g1_mul, hm.g1_add, hm.g1_neg, jhm.g1_mul, jhm.g1_add),
            (G2_GEN, hm.g2_mul, hm.g2_add, hm.g2_neg, jhm.g2_mul,
             jhm.g2_add)):
        pts = [mul(gen, k) for k in ks]
        assert pts == [jmul(gen, k) for k in ks]
        assert pts[0] is None and pts[4] == neg(gen)
        for a, b in zip(pts, pts[1:] + pts[:1]):
            assert add(a, b) == jadd(a, b)
        assert add(pts[5], pts[5]) == jadd(pts[5], pts[5])
        assert add(pts[5], neg(pts[5])) is None


def test_generators_and_from_affine():
    p = g1.generator((2,), device="cpu")
    assert [int(v) for v in fp.to_ints(p[0])] == [G1_GEN[0]] * 2
    assert g1.is_on_curve(p).all() and g2.is_on_curve(
        g2.generator((3,), device="cpu")).all()
    aff = g1.generator_affine((2,), device="cpu")
    inf = torch.tensor([False, True])
    q = g1.from_affine((aff[0], aff[1], inf))
    assert g1.is_identity(q).tolist() == [False, True]
    assert g1.eq(q, (p[0], p[1], p[2])).tolist() == [True, False]
    assert g2.is_identity(g2.identity((2,), device="cpu")).all()


# --- scans: against serial folds of a non-commutative combine -------------

M = 1_000_003


def affine_compose(l, r):
    """(a, b) as x -> a x + b; l then r.  Associative, not commutative."""
    (a1, b1), (a2, b2) = l, r
    return ((a1 * a2) % M, (b1 * a2 + b2) % M)


def serial_prefix(maps):
    out, acc = [], (1, 0)
    for m in maps:
        acc = affine_compose(acc, m)
        out.append(acc)
    return out


@pytest.mark.parametrize("n", [1, 2, 7, 8, 33])
def test_scans_match_serial_folds(n):
    maps = [(rng.randrange(1, M), rng.randrange(M)) for _ in range(n)]
    xs = (torch.tensor([[m[0] for m in maps]] * 2),
          torch.tensor([[m[1] for m in maps]] * 2))
    ident1 = (torch.ones((2, 1), dtype=torch.int64),
              torch.zeros((2, 1), dtype=torch.int64))

    def lanes(t):
        return list(zip(t[0][0].tolist(), t[1][0].tolist()))

    assert lanes(scans.inclusive_scan(affine_compose, xs, ident1)) == \
        serial_prefix(maps)
    suffix = [serial_prefix(maps[i:])[-1] for i in range(n)]
    assert lanes(scans.suffix_scan(affine_compose, xs, ident1)) == suffix
    red = scans.tree_reduce(affine_compose, xs, ident1)
    assert red[0].shape == (2, 1)
    assert lanes(red) == [serial_prefix(maps)[-1]]
