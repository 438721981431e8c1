"""The port's host oracle (`bls12_381_torch/hostmath.py`) against the JAX
package's (`bls12_381_tpu/hostmath.py`), function by function, on the same
seeded inputs and the edge values 0, 1, p - 1 and q - 1: the field helpers,
Fr, the curve objects (a negative scalar included), psi, the multi-Miller
loop, the SSWU maps and hash to curve (also through the 20 draft-16 KATs of
tests/vectors/h2c_kats.json), and the small names of `params` and
`fields/tower`.

Pure Python on both sides: no JAX device code runs.  Tolerance: none
(integers, bytes and None compare exactly).
"""

import json
import random

import numpy as np
import pytest

import conftest
from bls12_381_tpu import hostmath as jhm, params as jparams

from bls12_381_torch import hostmath as hm, params
from bls12_381_torch.fields import tower
from bls12_381_torch.params import G1_GEN, G2_GEN, P, Q

rng = random.Random(20261019)
np_rng = np.random.RandomState(20261019)

FP_EDGES = (0, 1, P - 1)
FR_EDGES = (0, 1, Q - 1)
H2C = json.loads((conftest.VECTORS / "h2c_kats.json").read_text())
KAT_DSTS = {
    "g1_ro": b"QUUX-V01-CS02-with-BLS12381G1_XMD:SHA-256_SSWU_RO_",
    "g1_nu": b"QUUX-V01-CS02-with-BLS12381G1_XMD:SHA-256_SSWU_NU_",
    "g2_ro": b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_",
    "g2_nu": b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_NU_",
}


def fp_values(n=6):
    return list(FP_EDGES) + [rng.randrange(P) for _ in range(n)]


def fp2_values(n=6):
    edges = [(a, b) for a in FP_EDGES for b in FP_EDGES]
    return edges + [(rng.randrange(P), rng.randrange(P)) for _ in range(n)]


def fp6_value():
    return tuple((rng.randrange(P), rng.randrange(P)) for _ in range(3))


# --- the field helpers -------------------------------------------------------


def test_fp_helpers_match_jax():
    xs = fp_values()
    for a in xs:
        assert hm.fp_neg(a) == jhm.fp_neg(a)
        assert hm.fp_sgn0(a) == jhm.fp_sgn0(a)
        for b in xs:
            for name in ("fp_add", "fp_sub", "fp_mul"):
                assert getattr(hm, name)(a, b) == getattr(jhm, name)(a, b)


def test_fp2_helpers_match_jax():
    for a in fp2_values():
        assert hm.fp2_is_zero(a) == jhm.fp2_is_zero(a)
        assert hm.fp2_sgn0(a) == jhm.fp2_sgn0(a)
    assert hm.fp2_is_zero((P, 0)) and jhm.fp2_is_zero((P, 0))


def test_fp6_fp12_helpers_match_jax():
    assert hm.FP12_ZERO == jhm.FP12_ZERO
    for _ in range(3):
        a = fp6_value()
        assert hm.fp6_square(a) == jhm.fp6_square(a)
        f, g = (fp6_value(), fp6_value()), (fp6_value(), fp6_value())
        assert hm.fp12_add(f, g) == jhm.fp12_add(f, g)
        assert hm.fp12_add(f, hm.FP12_ZERO) == f


def test_params_and_tower_names_match_jax():
    for name in ("FP_R", "FR_R", "FP_R2", "FR_R2", "FP_INV16", "FR_INV16"):
        assert getattr(params, name) == getattr(jparams, name), name
    assert tower.fp2_frobenius is tower.fp2_conjugate
    # the JAX table also holds constants only its device maps use
    assert hm.ISO_CONSTS == {k: jhm.ISO_CONSTS[k] for k in hm.ISO_CONSTS}


# --- Fr ----------------------------------------------------------------------


def test_fr_inv_matches_jax():
    for a in (1, 2, Q - 1, Q + 5) + tuple(rng.randrange(1, Q)
                                          for _ in range(8)):
        assert hm.fr_inv(a) == jhm.fr_inv(a)
    for mod in (hm, jhm):
        with pytest.raises(ZeroDivisionError):
            mod.fr_inv(0)
        with pytest.raises(ZeroDivisionError):
            mod.fr_inv(Q)


def test_fr_sqrt_matches_jax():
    """Residues, the edges and non-residues (7, the generator, and -7):
    the same root (Tonelli-Shanks, S = 32, z = 7) or None."""
    xs = list(FR_EDGES) + [4, 7, Q - 7] + [rng.randrange(Q)
                                            for _ in range(24)]
    roots = [hm.fr_sqrt(a) for a in xs]
    assert roots == [jhm.fr_sqrt(a) for a in xs]
    assert hm.fr_sqrt(7) is None and hm.fr_sqrt(Q - 1) is not None
    assert None in roots[6:] and any(r is not None for r in roots[6:])
    for a, r in zip(xs, roots):
        if r is not None:
            assert r * r % Q == a % Q


def test_fr_byte_codecs_match_jax():
    """Canonical values round-trip; q, q + 1 and 2^256 - 1 are rejected;
    the wide reduction of 64 bytes equals JAX's at the edges."""
    for a in list(FR_EDGES) + [rng.randrange(Q) for _ in range(6)]:
        b = hm.fr_to_bytes(a)
        assert b == jhm.fr_to_bytes(a)
        assert hm.fr_from_bytes(b) == jhm.fr_from_bytes(b) == a
    for v in (Q, Q + 1, (1 << 256) - 1):
        b = v.to_bytes(32, "little")
        assert hm.fr_from_bytes(b) is None and jhm.fr_from_bytes(b) is None
    wides = [bytes(64), b"\xff" * 64, Q.to_bytes(64, "little"),
             (Q - 1).to_bytes(64, "little")] + [
        bytes(np_rng.randint(0, 256, 64).astype(np.uint8)) for _ in range(4)]
    for w in wides:
        assert hm.fr_from_bytes_wide(w) == jhm.fr_from_bytes_wide(w)
    with pytest.raises(ValueError):
        hm.fr_from_bytes_wide(bytes(63))


# --- the curves --------------------------------------------------------------


def points(group):
    gen = {"g1": G1_GEN, "g2": G2_GEN}[group]
    mul = {"g1": hm.g1_mul, "g2": hm.g2_mul}[group]
    return [None, gen, mul(gen, 5), mul(gen, rng.randrange(1, Q))]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_curve_objects_match_jax(group):
    """G1_CURVE / G2_CURVE's JAX surface (negate, point_add, double,
    scalar_mul, is_on_curve) and the double aliases."""
    mine = {"g1": hm.G1_CURVE, "g2": hm.G2_CURVE}[group]
    ref = {"g1": jhm.G1_CURVE, "g2": jhm.G2_CURVE}[group]
    double = {"g1": (hm.g1_double, jhm.g1_double),
              "g2": (hm.g2_double, jhm.g2_double)}[group]
    pts = points(group)
    for a in pts:
        assert mine.negate(a) == ref.negate(a)
        assert mine.double(a) == ref.double(a) == double[0](a) == double[1](a)
        assert mine.is_on_curve(a) and ref.is_on_curve(a)
        for b in pts:
            assert mine.point_add(a, b) == ref.point_add(a, b)
        assert mine.point_add(a, mine.negate(a)) is None
    off = (1, 1) if group == "g1" else ((1, 0), (1, 0))
    assert mine.is_on_curve(off) is False and ref.is_on_curve(off) is False


@pytest.mark.parametrize("k", [-1, -3, -Q], ids=["-1", "-3", "-q"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_negative_scalars_match_jax(group, k):
    """[k]P for k < 0 is [|k|](-P), as in JAX's _Curve.scalar_mul, on the
    generator and on a point outside the subgroup (where [-q]P is not the
    identity)."""
    gen = {"g1": G1_GEN, "g2": G2_GEN}[group]
    out = {"g1": hm.g1_point_outside_subgroup,
           "g2": hm.g2_point_outside_subgroup}[group]()
    mul = {"g1": (hm.g1_mul, jhm.g1_mul), "g2": (hm.g2_mul, jhm.g2_mul)}[group]
    neg = {"g1": hm.g1_neg, "g2": hm.g2_neg}[group]
    for pt in (gen, out):
        got = mul[0](pt, k)
        assert got == mul[1](pt, k)
        assert got == mul[0](neg(pt), -k)
    assert mul[0](out, k) is not None


def test_psi_matches_jax():
    assert (hm.PSI_CX, hm.PSI_CY) == jhm._compute_psi_constants()
    assert hm._compute_psi_constants() == (hm.PSI_CX, hm.PSI_CY)
    for pt in points("g2") + [hm.g2_point_outside_subgroup()]:
        assert hm.g2_psi(pt) == jhm.g2_psi(pt)
    # psi acts as [z] = -[|z|] on G2
    assert hm.g2_psi(G2_GEN) == hm.g2_mul(G2_GEN, -params.BLS_X)


# --- the multi-Miller loop ----------------------------------------------------


def test_multi_miller_loop_matches_jax():
    """Three terms with a G1 identity: the Miller product and its final
    exponentiation equal JAX's, and the latter the product of the three
    pairings."""
    a, b = rng.randrange(1, Q), rng.randrange(1, Q)
    terms = [(hm.g1_mul(G1_GEN, a), hm.g2_mul(G2_GEN, b)),
             (None, hm.g2_mul(G2_GEN, 7)),
             (G1_GEN, hm.g2_neg(G2_GEN))]
    f = hm.multi_miller_loop(terms)
    assert f == jhm.multi_miller_loop(terms)
    e = hm.final_exponentiation(f)
    assert e == jhm.final_exponentiation(f)
    assert e == hm.fp12_pow(hm.gt_generator(), a * b - 1)
    assert hm.multi_miller_loop([]) == hm.FP12_ONE


def test_line_helpers_match_jax():
    p, t, q = hm.g1_mul(G1_GEN, 3), hm.g2_mul(G2_GEN, 5), G2_GEN
    assert hm._line_double(t, p) == jhm._line_double(t, p)
    assert hm._line_add(t, q, p) == jhm._line_add(t, q, p)
    ls = [(rng.randrange(P), rng.randrange(P)) for _ in range(3)]
    assert hm._sparse_line_045(*ls) == jhm._sparse_line_045(*ls)


# --- hash to curve -------------------------------------------------------------


def test_map_to_curve_matches_jax():
    """u = 0, 1, p - 1 and random values; (0, 0) and the Fp2 edges."""
    for u in fp_values(3):
        got = hm.map_to_curve_g1(u)
        assert got == jhm.map_to_curve_g1(u)
    for u in [(0, 0), (1, 0), (0, 1), (P - 1, P - 1)] + [
            (rng.randrange(P), rng.randrange(P)) for _ in range(2)]:
        assert hm.map_to_curve_g2(u) == jhm.map_to_curve_g2(u)


def test_sswu_pieces_match_jax():
    assert hm._i2osp(258, 2) == jhm._i2osp(258, 2) == b"\x01\x02"
    c = hm.ISO_CONSTS
    for u in (0, 5):
        args = (c["g1_sswu_a"], c["g1_sswu_b"], c["g1_sswu_xi"])
        pt = hm._sswu(u, *args, hm._FP_FIELD)
        assert pt == jhm._sswu(u, *args, jhm._FP_FIELD)
        iso = [c[f"iso11_{k}"] for k in ("xnum", "xden", "ynum", "yden")]
        assert hm._iso_map(pt, *iso, hm._FP_FIELD) == jhm._iso_map(
            pt, *iso, jhm._FP_FIELD)
    for name in ("one", "zero"):
        assert hm._FP_FIELD[name] == jhm._FP_FIELD[name]
        assert hm._FP2_FIELD[name] == jhm._FP2_FIELD[name]


@pytest.mark.parametrize("name", ["g1_ro", "g1_nu", "g2_ro", "g2_nu"])
def test_h2c_kats(name):
    """hash_to_curve (ro) / encode_to_curve (nu) of the five draft-16
    messages equal the expected points."""
    group = name[:2]
    kind = "hash" if name.endswith("ro") else "encode"
    fn = getattr(hm, f"{kind}_to_curve_{group}")
    enc = getattr(hm, f"{group}_to_uncompressed")
    for c in H2C[name]:
        assert enc(fn(c["msg"].encode(), KAT_DSTS[name])).hex() == \
            c["expected"]


def messages(n):
    """n seeded messages of mixed lengths, the empty one first."""
    return [b""] + [bytes(np_rng.randint(0, 256, length).astype(np.uint8))
                    for length in (3, 32, 100, 300)[:n - 1]]


@pytest.mark.parametrize("kind", ["hash", "encode"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_h2c_matches_jax(group, kind):
    """Four messages per function with the default XMD expander, and for
    G1 also through expand_message_xof (the expand= parameter)."""
    dst = KAT_DSTS[f"{group}_{'ro' if kind == 'hash' else 'nu'}"]
    name = f"{kind}_to_curve_{group}"
    mine, ref = getattr(hm, name), getattr(jhm, name)
    for m in messages(4):
        got = mine(m, dst)
        assert got == ref(m, dst)
        assert {"g1": hm.g1_is_torsion_free,
                "g2": hm.g2_is_torsion_free}[group](got)
    if group == "g1":
        for m in messages(2):
            assert mine(m, dst, expand=hm.expand_message_xof) == ref(
                m, dst, expand=jhm.expand_message_xof)
