"""The port's multiplication by |z|, subgroup checks and cofactor clearing
(`curves/g1.py`, `curves/g2.py`) against the JAX package on the CPU, and
the port's host square roots, torsion tests and cofactor clearing
(`hostmath`) against the JAX package's host oracle.

Tolerance: none (integer arithmetic) -- points compare limb for limb in
projective coordinates, subgroup checks as booleans, affine results with
the host's [h_eff]P.  Inputs: multiples of the generators in random
projective scalings, the identity, and points outside the subgroups as the
JAX package's tests make them (tests/test_device_curves.py:84-98,173-179:
the least x >= 5 on G1, a map-to-curve image on G2) plus the port's own
(`hostmath.g1/g2_point_outside_subgroup`).
"""

import random

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from bls12_381_tpu import hostmath as jhm
from bls12_381_tpu.curves import g1 as jg1, g2 as jg2
from bls12_381_tpu.fields import fp as jfp, tower as jtw

from bls12_381_torch import convert, hostmath as hm
from bls12_381_torch.curves import g1, g2
from bls12_381_torch.fields import fp, tower as tw
from bls12_381_torch.params import G1_GEN, G2_GEN, H_EFF_G1, H_EFF_G2, P, Q

torch.set_num_threads(1)
rng = random.Random(1130)


def jax_bad_g1():
    """The JAX package's test point: the least x >= 5 off G1."""
    x = 5
    while True:
        y = jhm.fp_sqrt((x * x * x + 4) % P)
        if y is not None and not jhm.g1_is_torsion_free((x, y)):
            return (x, y)
        x += 1


def g1_proj(pt):
    if pt is None:
        return (0, 1, 0)
    lam = rng.randrange(1, P)
    return (pt[0] * lam % P, pt[1] * lam % P, lam)


def g2_proj(pt):
    if pt is None:
        return ((0, 0), (1, 0), (0, 0))
    lam = (rng.randrange(1, P), rng.randrange(P))
    return (jhm.fp2_mul(pt[0], lam), jhm.fp2_mul(pt[1], lam), lam)


def lanes(group):
    """Host points: three subgroup points, the identity, two points outside
    the subgroup (the JAX tests' and the port's), their sum with a subgroup
    point, and the generator."""
    if group == "g1":
        mul, add, gen = jhm.g1_mul, jhm.g1_add, G1_GEN
        bad = [jax_bad_g1(), hm.g1_point_outside_subgroup()]
    else:
        mul, add, gen = jhm.g2_mul, jhm.g2_add, G2_GEN
        bad = [jhm.map_to_curve_g2((12345, 67890)),
               hm.g2_point_outside_subgroup()]
    good = [mul(gen, rng.randrange(1, Q)) for _ in range(3)]
    return good + [None] + bad + [add(bad[1], good[0]), gen]


def encode(group, pts):
    rows = [(g1_proj if group == "g1" else g2_proj)(p) for p in pts]
    if group == "g1":
        j = tuple(jfp.from_ints([r[i] for r in rows]) for i in range(3))
        return j, convert.g1_proj_to_torch(tuple(np.asarray(c) for c in j),
                                           "cpu")
    j = tuple(jtw.fp2_from_ints([r[i] for r in rows]) for i in range(3))
    return j, convert.g2_proj_to_torch(
        tuple(tuple(np.asarray(c) for c in f2) for f2 in j), "cpu")


def leaves(x):
    if isinstance(x, tuple):
        return [t for y in x for t in leaves(y)]
    return [np.asarray(x)]


def same_proj(group, port, jax_pt):
    conv = convert.g1_proj_from_torch if group == "g1" else \
        convert.g2_proj_from_torch
    return all(np.array_equal(a, b) for a, b in
               zip(leaves(conv(port)), leaves(jax_pt)))


def affine_host(group, port_pt):
    x, y, inf = (g1 if group == "g1" else g2).to_affine(port_pt)
    if group == "g1":
        return [None if i else (int(a), int(b)) for a, b, i in
                zip(fp.to_ints(x), fp.to_ints(y), inf.tolist())]
    (x0, x1), (y0, y1) = tw.fp2_to_ints(x), tw.fp2_to_ints(y)
    return [None if i else ((int(a), int(b)), (int(c), int(d)))
            for a, b, c, d, i in zip(x0, x1, y0, y1, inf.tolist())]


PORT = {"g1": g1, "g2": g2}
JAX = {"g1": jg1, "g2": jg2}


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("name", ["mul_by_x", "clear_cofactor"])
def test_matches_jax_projective(group, name):
    pts = lanes(group)
    jp, tp = encode(group, pts)
    got = getattr(PORT[group], name)(tp)
    assert same_proj(group, got, getattr(JAX[group], name)(jp))
    mul = jhm.g1_mul if group == "g1" else jhm.g2_mul
    if name == "mul_by_x":
        want = [mul(p, hm.BLS_X) if p else None for p in pts]
    else:
        clear = jhm.g1_clear_cofactor if group == "g1" else \
            jhm.g2_clear_cofactor
        want = [clear(p) if p else None for p in pts]
        assert PORT[group].is_torsion_free(got).all()
    assert affine_host(group, got) == want


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_is_torsion_free_matches_jax(group):
    pts = lanes(group)
    jp, tp = encode(group, pts)
    got = PORT[group].is_torsion_free(tp).numpy()
    assert np.array_equal(got, np.asarray(JAX[group].is_torsion_free(jp)))
    # subgroup points and the identity pass; the points outside fail
    assert got.tolist() == [True] * 4 + [False] * 3 + [True]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_psi_squared_and_identity(group):
    """The identity is torsion-free and clears to itself; on G2, psi2 is
    psi applied twice and acts as [z^2] on the subgroup."""
    mod = PORT[group]
    ident = mod.identity((2,), device="cpu")
    assert mod.is_torsion_free(ident).all()
    assert mod.is_identity(mod.clear_cofactor(ident)).all()
    if group == "g2":
        pts = lanes("g2")[:3]
        _, tp = encode("g2", pts)
        assert g2.eq(g2.psi2(tp), g2.psi(g2.psi(tp))).all()
        assert affine_host("g2", g2.psi2(tp)) == [
            jhm.g2_mul(p, hm.BLS_X ** 2 % Q) for p in pts]


def test_port_host_oracle_matches_jax():
    """The port's host square roots, torsion tests and cofactor clearing
    (the oracle of the card's subgroup rows, `test_torch_kernels_gpu.py`)
    equal the JAX package's."""
    for _ in range(6):
        a = rng.randrange(P)
        ours, theirs = hm.fp_sqrt(a), jhm.fp_sqrt(a)
        assert (ours is None) == (theirs is None)
        if ours is not None:
            assert ours * ours % P == a
        b = (rng.randrange(P), rng.randrange(P))
        ours, theirs = hm.fp2_sqrt(b), jhm.fp2_sqrt(b)
        assert (ours is None) == (theirs is None)
        if ours is not None:
            assert hm.fp2_square(ours) == b
    sq = hm.fp2_square((rng.randrange(P), rng.randrange(P)))
    assert hm.fp2_square(hm.fp2_sqrt(sq)) == sq
    assert hm.fp2_sqrt((0, 0)) == (0, 0)
    assert (hm.H_EFF_G1, hm.H_EFF_G2) == (jhm.H_EFF_G1, jhm.H_EFF_G2) == (
        H_EFF_G1, H_EFF_G2)
    b1, b2 = hm.g1_point_outside_subgroup(), hm.g2_point_outside_subgroup()
    assert b1 == jax_bad_g1()
    assert jhm.g1_is_on_curve(b1) and jhm.g2_is_on_curve(b2)
    for pt, ours, theirs in (
            (b1, hm.g1_is_torsion_free, jhm.g1_is_torsion_free),
            (b2, hm.g2_is_torsion_free, jhm.g2_is_torsion_free),
            (G1_GEN, hm.g1_is_torsion_free, jhm.g1_is_torsion_free),
            (G2_GEN, hm.g2_is_torsion_free, jhm.g2_is_torsion_free)):
        assert ours(pt) == theirs(pt)
    assert hm.g1_clear_cofactor(b1) == jhm.g1_clear_cofactor(b1)
    assert hm.g2_clear_cofactor(b2) == jhm.g2_clear_cofactor(b2)
