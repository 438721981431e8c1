"""The port's Pippenger MSM (bls12_381_torch.ops.msm) on the CPU against the
JAX package: its host oracle's serial fold sum_i [k_i] P_i
(`bls12_381_tpu.hostmath`) and its `msm_g1`, plus the scalar splits the MSM
runs on (`limbs.barrett_divmod`, the signed digits).

Tolerance: none (integer arithmetic) -- group elements compare exactly:
affine against the JAX package's host oracle (the port's projective result
decoded by the JAX package's `to_ints` and a host inversion), projective
limb for limb against the JAX package's `msm_g1` and `msm_g2` (the same
stable sort gives the same order of additions).  Inputs are seeded multiples of the
generators and seeded scalars, with zero scalars, identity points and the
scalar q-1.
"""

import random

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax.numpy as jnp
from bls12_381_tpu import hostmath as jhm
from bls12_381_tpu import limbs as jlb
from bls12_381_tpu.curves import g1 as jg1, g2 as jg2
from bls12_381_tpu.fields import fp as jfp, fr as jfr, tower as jtw
from bls12_381_tpu.ops import msm as jmsm
from bls12_381_tpu.params import BLS_X, G1_GEN, G2_GEN, P, Q

from bls12_381_torch import convert, entry, limbs
from bls12_381_torch.curves import g1, g2
from bls12_381_torch.fields import fr, tower as tw
from bls12_381_torch.ops import msm

torch.set_num_threads(1)
rng = random.Random(13)


def g1_points(host_pts):
    """Host affine points (None = identity) -> (JAX, port) projective."""
    inf = np.array([p is None for p in host_pts])
    xs = [p[0] if p else 0 for p in host_pts]
    ys = [p[1] if p else 1 for p in host_pts]
    j = jg1.from_affine((jfp.from_ints(xs), jfp.from_ints(ys),
                         jnp.asarray(inf)))
    return j, convert.g1_proj_to_torch(tuple(np.asarray(c) for c in j), "cpu")


def g2_points(host_pts):
    """Host affine G2 points (None = identity) -> (JAX, port) projective."""
    inf = np.array([p is None for p in host_pts])
    xs = [p[0] if p else (0, 0) for p in host_pts]
    ys = [p[1] if p else (1, 0) for p in host_pts]
    j = jg2.from_affine((jtw.fp2_from_ints(xs), jtw.fp2_from_ints(ys),
                         jnp.asarray(inf)))
    return j, convert.g2_proj_to_torch(
        tuple(tuple(np.asarray(c) for c in f2) for f2 in j), "cpu")


def serial(mul, add, host_pts, ks):
    acc = None
    for k, p in zip(ks, host_pts):
        if p is not None:
            acc = add(acc, mul(p, k))
    return acc


def dec_g1(proj):
    """A port projective point, batch shape () -> host affine ints (None
    for the identity), decoded on the JAX package's side."""
    x, y, z = (int(jfp.to_ints(c)) for c in convert.g1_proj_from_torch(proj))
    if z == 0:
        return None
    zi = pow(z, -1, P)
    return (x * zi % P, y * zi % P)


def dec_g2(proj):
    x, y, z = (tuple(int(v) for v in jtw.fp2_to_ints(c))
               for c in convert.g2_proj_from_torch(proj))
    if z == (0, 0):
        return None
    zi = jhm.fp2_inv(z)
    return (jhm.fp2_mul(x, zi), jhm.fp2_mul(y, zi))


def rand_g1(n):
    return [jhm.g1_mul(G1_GEN, rng.randrange(1, 1 << 20)) for _ in range(n)]


def test_msm_g1_matches_serial_and_jax():
    n = 32
    ks = [rng.randrange(Q) for _ in range(n)]
    pts = rand_g1(n)
    jp, tp = g1_points(pts)
    got = msm.msm_g1(tp, fr.from_ints(ks, device="cpu"), c=4)
    assert dec_g1(got) == serial(jhm.g1_mul, jhm.g1_add, pts, ks)
    want = jmsm.msm_g1(jp, jfr.from_ints(ks), c=4)
    for a, b in zip(convert.g1_proj_from_torch(got), want):
        assert np.array_equal(a, np.asarray(b))


def test_msm_with_zero_scalars_and_identity_points():
    ks = [0, 1, 2, 0, 5, 0, 7, Q - 1]
    pts = [jhm.g1_mul(G1_GEN, i + 1) for i in range(8)]
    pts[2] = pts[5] = None
    _, tp = g1_points(pts)
    got = msm.msm_g1(tp, fr.from_ints(ks, device="cpu"), c=4)
    assert dec_g1(got) == serial(jhm.g1_mul, jhm.g1_add, pts, ks)


def test_msm_g1_large_folds_chunks():
    n = 8
    ks = [rng.randrange(Q) for _ in range(n)]
    pts = rand_g1(n)
    _, tp = g1_points(pts)
    sc = fr.from_ints(ks, device="cpu")
    got = msm.msm_g1_large(tp, sc, c=4, chunk_log2=2)
    assert bool(g1.eq(got, msm.msm_g1(tp, sc, c=4)))
    assert dec_g1(got) == serial(jhm.g1_mul, jhm.g1_add, pts, ks)


@pytest.fixture(scope="module")
def large64():
    """msm_g1_large over `entry.msm_inputs`' 2^6 points (an identity point,
    a zero scalar) in two chunks of 2^5 at c = 4, run once on the plain
    path with its calls counted: (points, scalars, counts, value)."""
    from test_torch_smul import count_launches

    pts, sc = entry.msm_inputs(6, "g1", seed=7, device="cpu")
    counts, got = count_launches(msm.msm_g1_large, pts, sc, 4, True, 5)
    return pts, sc, counts, got


def host_msm_g1(pts, sc):
    """[sum_i k_i (i+1) mod q]G of `entry.msm_inputs`' points, by the JAX
    package's host oracle."""
    ks = [int(k) for k in jfr.to_ints(convert.fr_from_torch(sc))]
    inf = g1.is_identity(pts).tolist()
    total = sum(k * (i + 1) for i, (k, o) in enumerate(zip(ks, inf))
                if not o) % Q
    return jhm.g1_mul(G1_GEN, total)


def test_msm_g1_large_matches_jax_projective(large64):
    """msm_g1_large over two chunks of 2^5 points at c = 4 against the JAX
    package's msm_g1_large on the same inputs, limb for limb in projective
    coordinates (its chunks are msm_g1 at 32 points and c = 4, compiled
    once in this file), and against the host oracle."""
    pts, sc, _, got = large64
    jp = tuple(jnp.asarray(c) for c in convert.g1_proj_from_torch(pts))
    want = jmsm.msm_g1_large(jp, jnp.asarray(convert.fr_from_torch(sc)),
                             c=4, chunk_log2=5)
    for a, b in zip(convert.g1_proj_from_torch(got), want):
        assert np.array_equal(a, np.asarray(b))
    assert dec_g1(got) == host_msm_g1(pts, sc)


def test_msm_entry_gives_msm_g1_large(large64, monkeypatch):
    """`entry.msm_entry(..., "g1")` returns msm_g1_large, which up to
    2^chunk_log2 points is one call of msm_g1 with the caller's arguments
    (so the rows up to 2^21 points launch what they did), and over chunks
    gives the point msm_g1 gives, the host oracle's."""
    fn, (pts, sc) = entry.msm_entry(4, "g1", seed=7, device="cpu")
    assert fn is msm.msm_g1_large
    calls = []
    monkeypatch.setattr(msm, "msm_g1", lambda *a, **k: calls.append(
        (a, k)) or "msm_g1's value")
    assert fn(pts, sc, 5, False, chunk_log2=4) == "msm_g1's value"
    assert calls == [((pts, sc), {"c": 5, "glv": False})]
    pts, sc, _, got = large64
    assert dec_g1(got) == host_msm_g1(pts, sc)


def test_msm_large_launch_schedule(large64):
    """The plain path's calls of msm_g1_large over two chunks of 2^5
    points against `port_cases.expected_msm_large_launches` (two msm_g1
    schedules and the fold's one add); over one chunk the formula is
    `expected_msm_launches`."""
    import port_cases

    assert large64[2] == port_cases.expected_msm_large_launches(64, 4, 5)
    assert port_cases.expected_msm_large_launches(64, 4, 6) == \
        port_cases.expected_msm_launches("g1", 64, 4)
    two = port_cases.expected_msm_launches("g1", 32, 4)
    assert large64[2]["plan_exec"] == 2 * two["plan_exec"] + 1


def test_msm_g2_matches_serial():
    n = 8
    ks = [rng.randrange(Q) for _ in range(n - 1)] + [Q - 1]
    pts = [jhm.g2_mul(G2_GEN, rng.randrange(1, 1 << 20)) for _ in range(n)]
    pts[3] = None
    got = msm.msm_g2(g2_points(pts)[1], fr.from_ints(ks, device="cpu"), c=4)
    assert dec_g2(got) == serial(jhm.g2_mul, jhm.g2_add, pts, ks)


def test_msm_g2_matches_jax_projective():
    """msm_g2 (GLS) at n = 8, c = 4 against the JAX package's msm_g2 limb
    for limb in projective coordinates, an identity point and the scalars
    0 and q-1 among the inputs."""
    n = 8
    ks = [0] + [rng.randrange(Q) for _ in range(n - 2)] + [Q - 1]
    pts = [jhm.g2_mul(G2_GEN, rng.randrange(1, 1 << 20)) for _ in range(n)]
    pts[5] = None
    jq, tq = g2_points(pts)
    got = msm.msm_g2(tq, fr.from_ints(ks, device="cpu"), c=4)
    want = jmsm.msm_g2(jq, jfr.from_ints(ks), c=4)
    for a, b in zip(convert.g2_proj_from_torch(got), want):
        for a2, b2 in zip(a, b):
            assert np.array_equal(a2, np.asarray(b2))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_entry_on_cpu(group):
    """msm_inputs: [i+1]G with identity lanes and zero scalars; the MSM of
    them is [sum_i k_i (i+1)]G over the other lanes."""
    fn, (pts, sc) = entry.msm_entry(4, group, seed=7, device="cpu")
    mod, mul, gen = {"g1": (g1, jhm.g1_mul, G1_GEN),
                     "g2": (g2, jhm.g2_mul, G2_GEN)}[group]
    inf = mod.is_identity(pts).tolist()
    ks = [int(k) for k in jfr.to_ints(convert.fr_from_torch(sc))]
    assert inf[entry.MSM_IDENTITY_LANE] and sum(inf) == 1
    assert ks[entry.MSM_ZERO_LANE] == 0 and all(ks[:entry.MSM_ZERO_LANE])
    total = sum(k * (i + 1) for i, (k, o) in enumerate(zip(ks, inf))
                if not o) % Q
    dec = dec_g1 if group == "g1" else dec_g2
    assert dec(fn(pts, sc, c=4)) == mul(gen, total)


def test_scalar_splits_match_jax():
    """GLV (by z^2, 9 quotient limbs) and GLS (by |z|^3, |z|^2, |z| with
    5) divisions and the balanced digits, with 0, 1 and q-1."""
    ks = [0, 1, Q - 1] + [rng.randrange(Q) for _ in range(13)]
    jc = jlb.from_mont(jlb.FR, jfr.from_ints(ks))
    tc = convert.fr_to_torch(np.asarray(jc), "cpu")
    assert [int(v) for v in limbs.to_ints(limbs.FR, tc, from_mont=False)] \
        == ks

    def same(t, j):
        return np.array_equal(t.numpy().astype(np.int64),
                              np.asarray(j).astype(np.int64))

    for d, q_limbs in ((BLS_X ** 2, 9), (BLS_X ** 3, 5)):
        q, r = limbs.barrett_divmod(tc, d, q_limbs)
        jq, jr = jlb.barrett_divmod(jc, d, q_limbs)
        assert same(q, jq) and same(r, jr)
        assert [int(v) for v in limbs.to_ints(limbs.FR, r, from_mont=False)] \
            == [k % d for k in ks]
    for c, bits in ((4, 128), (12, 255), (12, 64)):
        mags, negs = limbs.signed_digits_lsb(tc, bits, c)
        jm, jn = jmsm._signed_digits(jc, c, bits)
        assert same(mags, jm) and same(negs, jn)
