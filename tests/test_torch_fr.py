"""The port's scalar field (bls12_381_torch.fields.fr, the Fr route of
limbs and kernels/mont.py) against the JAX package on the CPU.

Tolerance: none (integer arithmetic) -- every comparison is exact equality
of 16-bit limbs or of Python integers.  Inputs come from a seeded generator
plus the edge values 0, 1 and q-1; data crosses between the packages as
numpy via bls12_381_torch.convert.
"""

import random

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax.numpy as jnp
from bls12_381_tpu import limbs as jlb
from bls12_381_tpu.fields import fr as jfr
from bls12_381_tpu.kernels import pallas_mont

from bls12_381_torch import convert, limbs
from bls12_381_torch.fields import fr
from bls12_381_torch.kernels import mont
from bls12_381_torch.params import Q

torch.set_num_threads(1)
R = 1 << 256
RINV = pow(R, -1, Q)
rng = random.Random(4321)
np_rng = np.random.default_rng(4321)
EDGES = [0, 1, Q - 1]


def rvals(n):
    return EDGES + [rng.randrange(Q) for _ in range(n - len(EDGES))]


def both(vals):
    """(JAX array, port tensor) of the same Montgomery-encoded values."""
    j = jfr.from_ints(vals)
    return j, convert.fr_to_torch(np.asarray(j), "cpu")


def same(port, jax_arr):
    return np.array_equal(convert.fr_from_torch(port), np.asarray(jax_arr))


A_VALS = rvals(12)
B_VALS = [Q - 1, 0, Q - 1] + rvals(12)[3:]


def test_constants_and_codecs_match_jax():
    for name in ("GENERATOR", "S", "ROOT_OF_UNITY", "TWO_INV",
                 "ROOT_OF_UNITY_INV", "DELTA"):
        assert getattr(fr, name) == getattr(jfr, name), name
    assert fr.root_of_unity_pow(12345) == jfr.root_of_unity_pow(12345)
    assert limbs.FR.max_terms == 2 and limbs.FP.max_terms == 8
    ja, ta = both(A_VALS)
    assert same(fr.from_ints(A_VALS, device="cpu"), ja)
    assert [int(v) for v in fr.to_ints(ta)] == A_VALS
    assert same(fr.from_ints(A_VALS, to_mont=False, device="cpu"),
                jfr.from_ints(A_VALS, to_mont=False))
    assert same(fr.one((4,), device="cpu"), jfr.one((4,)))
    assert same(fr.zero((4,), device="cpu"), jfr.zero((4,)))
    assert same(fr.const(7, (3,), device="cpu"), jfr.const(7, (3,)))
    assert same(limbs.from_mont(limbs.FR, ta), jlb.from_mont(jlb.FR, ja))
    raw = fr.from_ints(A_VALS, to_mont=False, device="cpu")
    assert same(limbs.to_mont(limbs.FR, raw), ja)


@pytest.mark.parametrize("op", ["add", "sub", "neg", "mul", "sqr"])
def test_arithmetic_matches_jax(op):
    ja, ta = both(A_VALS)
    jb, tb = both(B_VALS)
    ge = [x for x in EDGES for _ in EDGES]
    he = [y for _ in EDGES for y in EDGES]
    jx, tx = both(ge)
    jy, ty = both(he)
    if op in ("neg", "sqr"):
        assert same(getattr(fr, op)(ta), getattr(jfr, op)(ja))
        assert same(getattr(fr, op)(tx), getattr(jfr, op)(jx))
    else:
        assert same(getattr(fr, op)(ta, tb), getattr(jfr, op)(ja, jb))
        # every pair of edge values, both orders
        assert same(getattr(fr, op)(tx, ty), getattr(jfr, op)(jx, jy))


def test_predicates_and_select_match_jax():
    ja, ta = both(A_VALS)
    jb, tb = both(B_VALS)
    assert np.array_equal(fr.is_zero(ta).numpy(), np.asarray(jfr.is_zero(ja)))
    assert np.array_equal(fr.eq(ta, tb).numpy(), np.asarray(jfr.eq(ja, jb)))
    mask = np.array([i % 3 == 0 for i in range(len(A_VALS))])
    assert same(fr.select(torch.from_numpy(mask), ta, tb),
                jfr.select(jnp.asarray(mask), ja, jb))


def test_inv_pow_fixed_and_pow_runtime_match_jax():
    ja, ta = both(A_VALS[:6])
    inv = fr.inv(ta)
    assert same(inv, jfr.inv(ja))
    vals = [int(v) for v in fr.to_ints(inv)]
    assert vals[0] == 0 and all(v * x % Q == 1
                                for v, x in zip(vals[1:], A_VALS[1:6]))
    assert same(fr.pow_fixed(ta, 0xDEADBEEF12345), jfr.pow_fixed(ja, 0xDEADBEEF12345))
    # runtime exponents per lane, with the edge exponents 0, 1, q-1
    exps = [0, 1, Q - 1] + [rng.randrange(Q) for _ in range(3)]
    je, te = both(exps)
    je_raw = jlb.from_mont(jlb.FR, je)
    te_raw = limbs.from_mont(limbs.FR, te)
    assert same(te_raw, je_raw)
    got = fr.pow(ta, te_raw)
    assert same(got, jfr.pow(ja, je_raw))
    assert [int(v) for v in fr.to_ints(got)] == [
        pow(x, e, Q) for x, e in zip(A_VALS[:6], exps)]


@pytest.mark.parametrize("n", [5, 20])
def test_batch_inv_matches_jax(n):
    """n = 5 is per-lane inversion; n = 20 takes the product scans (padded
    to 32 lanes); zeros map to zero."""
    vals = [0] + [rng.randrange(1, Q) for _ in range(n - 3)] + [0, Q - 1]
    ja, ta = both(vals)
    got = fr.batch_inv(ta)
    assert same(got, jfr.batch_inv(ja))
    assert [int(v) for v in fr.to_ints(got)] == [
        pow(v, Q - 2, Q) for v in vals]


def test_sqrt_matches_jax():
    """Residues (squares, 0, 1, q-1) and non-residues (the generator 7 and
    its odd powers): same root, same ok mask."""
    sq = [pow(rng.randrange(Q), 2, Q) for _ in range(2)]
    vals = [0, 1, Q - 1, fr.GENERATOR, pow(fr.GENERATOR, 3, Q)] + sq + [
        rng.randrange(Q)]
    ja, ta = both(vals)
    root, ok = fr.sqrt(ta)
    jroot, jok = jfr.sqrt(ja)
    assert same(root, jroot)
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    assert not ok[3] and not ok[4] and ok[:3].all() and ok[5:7].all()
    for v, r, good in zip(vals, fr.to_ints(root), ok.tolist()):
        assert not good or int(r) * int(r) % Q == v


def test_byte_codecs_match_jax():
    wide = np_rng.integers(0, 256, (6, 64), dtype=np.uint8)
    wide[0] = 255  # the largest 512-bit value
    wide[1] = 0
    assert same(fr.from_bytes_wide(torch.from_numpy(wide)),
                jfr.from_bytes_wide(jnp.asarray(wide)))
    assert same(fr.from_bytes_wide(wide, device="cpu"),
                jfr.from_bytes_wide(jnp.asarray(wide)))
    assert same(fr.from_bytes_wide_host(wide, device="cpu"),
                jfr.from_bytes_wide_host(wide))
    okm = np_rng.integers(0, 256, (4, 48), dtype=np.uint8)
    assert same(fr.from_okm(torch.from_numpy(okm)),
                jfr.from_okm(jnp.asarray(okm)))
    narrow = np_rng.integers(0, 256, (5, 32), dtype=np.uint8)
    narrow[0] = 255                                    # >= q: invalid
    narrow[1] = np.frombuffer((Q - 1).to_bytes(32, "little"), np.uint8)
    narrow[2] = np.frombuffer(Q.to_bytes(32, "little"), np.uint8)  # invalid
    narrow[3, 31] &= 0x3F                              # < 2^254: valid
    t, ok = fr.from_bytes_host(narrow, device="cpu")
    jt, jok = jfr.from_bytes_host(narrow)
    assert same(t, jt)
    assert np.array_equal(ok, np.asarray(jok))
    assert ok.tolist()[:4] == [False, True, False, True]
    ja, ta = both(A_VALS)
    assert np.array_equal(fr.to_bytes_host(ta), jfr.to_bytes_host(ja))


def test_three_term_sum_chunks_at_two():
    """A 3-term Fr sum runs as 2 + 1 fused terms and the partials added,
    so it is canonical even where one reduction of all three would not be
    (every operand q-1: 3 (q-1)^2 / R + q > 2q)."""
    rows = [[Q - 1] * 4, [Q - 1, 1, 0, rng.randrange(Q)],
            [Q - 1, Q - 1, 1, rng.randrange(Q)]]
    pairs = [(fr.from_ints(r, to_mont=False, device="cpu"),
              fr.from_ints(r[::-1], to_mont=False, device="cpu"))
             for r in rows]
    got = fr.to_ints(limbs.sum_of_products(limbs.FR, pairs), from_mont=False)
    for lane in range(4):
        exp = sum(r[lane] * r[3 - lane] for r in rows) * RINV % Q
        assert int(got[lane]) == exp


def test_plain_sop_fr_matches_pallas_interpret():
    """The plain Fr sop (the kernel's CPU version) against sop_pallas's
    Fr route in interpret mode (vectorized 16-bit version 5)."""
    nb = 32
    a_np = np.stack([np.asarray(jfr.from_ints(rvals(nb))) for _ in range(2)])
    b_np = np.stack([np.asarray(jfr.from_ints(rvals(nb)[::-1]))
                     for _ in range(2)])
    exp = pallas_mont.sop_pallas(
        jnp.asarray(a_np), jnp.asarray(b_np), n_limbs=jlb.FR.n_limbs,
        inv16=jlb.FR.inv16, p_limbs=tuple(int(x) for x in jlb.FR.p_limbs),
        block_b=32, interpret=True, version=5)
    got = mont.sop_fr_plain(torch.from_numpy(a_np.astype(np.int32)),
                            torch.from_numpy(b_np.astype(np.int32)))
    assert same(got, exp)
    for T in (1, 2):
        assert torch.equal(
            mont.sop_fr(torch.from_numpy(a_np[:T].astype(np.int32)),
                        torch.from_numpy(b_np[:T].astype(np.int32))),
            mont.sop_fr_plain(torch.from_numpy(a_np[:T].astype(np.int32)),
                              torch.from_numpy(b_np[:T].astype(np.int32))))


def test_plain_butterfly_matches_pallas_interpret():
    """butterfly_plain against butterfly_pallas in interpret mode
    (variant "vector"), with the rows that take the -q correction on lo
    and the +q correction on hi."""
    va = [0, 1, Q - 1, Q - 2, 0, Q - 1] + rvals(26)
    vb = [Q - 1, 0, Q - 1, 1, 0, 1] + rvals(26)
    vw = [Q - 1, 5, Q - 1, 1, 7, Q - 1] + rvals(26)
    (ja, ta), (jb, tb), (jw, tw) = both(va), both(vb), both(vw)
    exp = pallas_mont.butterfly_pallas(
        ja, jb, jw, n_limbs=jlb.FR.n_limbs, inv16=jlb.FR.inv16,
        p_limbs=tuple(int(x) for x in jlb.FR.p_limbs), block_b=32,
        interpret=True, variant="vector")
    got = mont.butterfly(ta, tb, tw)
    assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(exp))
    lo, hi = fr.to_ints(got[0]), fr.to_ints(got[1])
    for i in range(len(va)):
        t = vb[i] * vw[i] % Q
        assert int(lo[i]) == (va[i] + t) % Q and int(hi[i]) == (va[i] - t) % Q


def test_butterfly_broadcasts_as_jax():
    """fr.butterfly broadcasts and flattens [16, *batch] operands: a
    [16, 2, 3] batch against a [16, 1, 3] twiddle row."""
    va = [[rng.randrange(Q) for _ in range(3)] for _ in range(2)]
    vb = [[rng.randrange(Q) for _ in range(3)] for _ in range(2)]
    vw = [[rng.randrange(Q) for _ in range(3)]]
    (ja, ta), (jb, tb), (jw, tw) = both(va), both(vb), both(vw)
    lo, hi = fr.butterfly(ta, tb, tw)
    jlo, jhi = jfr.butterfly(ja, jb, jw)
    assert lo.shape == (16, 2, 3) and same(lo, jlo) and same(hi, jhi)


def test_fr_wrappers_validate_inputs():
    x = torch.zeros((3, 16, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="1..2"):
        mont.sop_fr(x, x)  # T = 3 > 2
    with pytest.raises(ValueError):
        mont.sop_fr(x[:1, :12], x[:1, :12])  # not 16 limbs
    with pytest.raises(ValueError):
        mont.butterfly(x[0], x[0], x[0, :, :3])  # lanes differ
    with pytest.raises(ValueError):
        mont.butterfly(x[0].long(), x[0], x[0])
    meta = torch.zeros((16, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mont.butterfly(meta, meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        mont.sop_fr(meta[None], meta[None])


@pytest.mark.parametrize("check", [
    "psi", "fr_sqrt", "fr_inv", "fr_from_bytes", "fr_to_bytes",
    "fr_from_bytes_wide", "fp_from_bytes"])
def test_phase_oracle_launch_schedules(check):
    """`port_cases.expected_oracle_launches` of the device calls held to
    the host oracle outside hash to curve and the multi-pairing (their schedules
    are `expected_h2c_launches` and `expected_parallel_launches`, held in
    test_torch_h2c.py and test_torch_parallel.py), by counting the plain
    versions' calls at 8 lanes."""
    import port_cases
    from test_torch_smul import count_launches

    from bls12_381_torch import entry
    from bls12_381_torch.curves import g2
    from bls12_381_torch.fields import fp

    n = 8
    vals = rvals(n)
    pts = entry.msm_inputs(3, "g2", device="cpu")[0]
    calls = {
        "psi": lambda: g2.psi(pts),
        "fr_sqrt": lambda: fr.sqrt(fr.from_ints(vals, device="cpu")),
        "fr_inv": lambda: fr.inv(fr.from_ints(vals[1:], device="cpu")),
        "fr_from_bytes": lambda: fr.from_bytes_host(
            np.zeros((n, 32), np.uint8), device="cpu"),
        "fr_to_bytes": lambda: fr.to_bytes_host(
            fr.from_ints(vals, device="cpu")),
        "fr_from_bytes_wide": lambda: fr.from_bytes_wide_host(
            np.full((n, 64), 255, np.uint8), device="cpu"),
        "fp_from_bytes": lambda: fp.from_bytes_host(
            np.zeros((n, 48), np.uint8), device="cpu"),
    }
    counts, _ = count_launches(calls[check])
    assert counts == port_cases.expected_oracle_launches(check, n)
