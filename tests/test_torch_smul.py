"""The port's scalar multiplications (`curves/g1.py`, `curves/g2.py`,
`curves/weierstrass.py`) and their digit recoders (`limbs.digits4_msb`,
`limbs.signed_digits_msb`) against the JAX package on the CPU, and the
launch schedules of `tests/port_cases.py`, which the card tests hold the
card to, counted here through the kernels' plain versions.

Tolerance: none (integer arithmetic) -- digits compare as arrays, points
limb for limb in projective coordinates (the port keeps the JAX package's
schedules: start from the identity, order of the table's adds, zero padding
of the digit lists), and affine results equal the JAX package's host
oracle.  Each JAX function is called once, on one batch of 9 lanes: the JAX
edge scalars (tests/test_device_curves.py:141-157) on multiples of the
generator in random projective scalings, and an identity point.
"""

import collections
import random

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax.numpy as jnp
from bls12_381_tpu import hostmath as jhm, limbs as jlimbs
from bls12_381_tpu.curves import g1 as jg1, g2 as jg2
from bls12_381_tpu.fields import fp as jfp, fr as jfr, tower as jtw

import chip_smoke
import port_cases
from bls12_381_torch import convert, entry, limbs, params
from bls12_381_torch.curves import g1, g2
from bls12_381_torch.fields import fp, tower as tw
from bls12_381_torch.kernels import LAUNCHES, keccak, mont, plan_exec as pe, sha256
from bls12_381_torch.pairing import gt
from bls12_381_torch.params import BLS_X, G1_GEN, G2_GEN, P, Q

torch.set_num_threads(1)
rng = random.Random(20261017)

EDGE_SCALARS = [0, 1, Q - 1, BLS_X ** 2 - 1, BLS_X ** 2, BLS_X ** 2 + 1,
                BLS_X ** 3, 12345]


# --- digit recoders ---------------------------------------------------------


def edge_values(n_limbs: int):
    """Values of n_limbs limbs: all ones, zero, digit and window boundaries
    (2^k - 1, 2^k, runs of 8s that carry through every digit), then
    random."""
    top = 1 << (16 * n_limbs)
    vals = [top - 1, 0, 1, 7, 8, 9, 15, 16, 0x8888, 0x7777]
    for k in (16, 63, 64, 65, 127, 128, 129, 16 * n_limbs - 1):
        vals += [(1 << k) - 1, 1 << k, (1 << k) + 8]
    vals += [int("8" * (4 * n_limbs), 16), int("7" * (4 * n_limbs), 16)]
    vals += [rng.randrange(top) for _ in range(24)]
    return [v % top for v in vals]


def limb_arrays(vals, n_limbs: int):
    arr = np.array([params.to_limbs(v, n_limbs) for v in vals],
                   dtype=np.uint32).T
    return jnp.asarray(arr), torch.from_numpy(arr.astype(np.int32))


@pytest.mark.parametrize("n_limbs,n_bits", [(9, 128), (5, 64), (16, 255),
                                            (16, 256), (9, 130)])
def test_digits4_msb_matches_jax(n_limbs, n_bits):
    ja, ta = limb_arrays(edge_values(n_limbs), n_limbs)
    got = limbs.digits4_msb(ta, n_bits)
    assert got.dtype == limbs.DTYPE
    assert np.array_equal(got.numpy(), np.asarray(jlimbs.digits4_msb(ja,
                                                                     n_bits)))


@pytest.mark.parametrize("n_limbs,n_bits,window", [
    (9, 128, 4), (5, 64, 4), (16, 255, 4), (16, 256, 4),
    # windows that straddle limbs: the right-shifted parts (shift < 0)
    (9, 128, 5), (5, 64, 3), (16, 255, 6)])
def test_signed_digits_msb_matches_jax(n_limbs, n_bits, window):
    vals = edge_values(n_limbs)
    ja, ta = limb_arrays(vals, n_limbs)
    mags, negs = limbs.signed_digits_msb(ta, n_bits, window)
    jm, jn = jlimbs.signed_digits_msb(ja, n_bits, window)
    assert np.array_equal(mags.numpy(), np.asarray(jm))
    assert np.array_equal(negs.numpy(), np.asarray(jn))
    # the digits recompose the value below 2^n_bits; the top one >= 0
    d = (mags.long() * (1 - 2 * negs.long())).numpy()
    for lane, v in enumerate(vals):
        if v < 1 << n_bits:
            assert sum(int(x) << (window * i) for i, x in
                       enumerate(d[::-1, lane])) == v
    assert not negs[0].any() and int(mags[1:].max()) <= 1 << (window - 1)


# --- scalar multiplications against the JAX package ------------------------


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


GROUPS = {
    "g1": dict(gen=G1_GEN, mul=jhm.g1_mul, proj=g1_proj, port=g1, jax=jg1,
               enc=lambda rows: tuple(jfp.from_ints([r[i] for r in rows])
                                      for i in range(3)),
               to_torch=convert.g1_proj_to_torch,
               from_torch=convert.g1_proj_from_torch),
    "g2": dict(gen=G2_GEN, mul=jhm.g2_mul, proj=g2_proj, port=g2, jax=jg2,
               enc=lambda rows: tuple(jtw.fp2_from_ints([r[i] for r in rows])
                                      for i in range(3)),
               to_torch=convert.g2_proj_to_torch,
               from_torch=convert.g2_proj_from_torch),
}


def numpy_tree(x):
    if isinstance(x, tuple):
        return tuple(numpy_tree(y) for y in x)
    return np.asarray(x)


def smul_inputs(group: str):
    """(JAX points, port points, JAX scalars, port scalars, host points,
    scalars): [m_i]G in random scalings with the edge scalars, and the
    identity with 12345."""
    g = GROUPS[group]
    ms = [rng.randrange(1, Q) for _ in EDGE_SCALARS] + [None]
    pts = [None if m is None else g["mul"](g["gen"], m) for m in ms]
    ks = EDGE_SCALARS + [12345]
    jp = g["enc"]([g["proj"](p) for p in pts])
    js = jfr.from_ints(ks)
    return (jp, g["to_torch"](numpy_tree(jp), "cpu"), js,
            convert.fr_to_torch(np.asarray(js), "cpu"), pts, ks)


def same_proj(group, port, jax_pt):
    got = GROUPS[group]["from_torch"](port)
    return all(np.array_equal(a, b) for a, b in
               zip(jax_tree_leaves(got), jax_tree_leaves(numpy_tree(jax_pt))))


def jax_tree_leaves(x):
    if isinstance(x, tuple):
        return [t for y in x for t in jax_tree_leaves(y)]
    return [x]


def affine_host(group, port_pt):
    """Port projective points -> host affine ints (None for identity)."""
    x, y, inf = GROUPS[group]["port"].to_affine(port_pt)
    if group == "g1":
        xy = zip(fp.to_ints(x), fp.to_ints(y))
        return [None if i else (int(a), int(b))
                for (a, b), i in zip(xy, inf.tolist())]
    (x0, x1), (y0, y1) = tw.fp2_to_ints(x), tw.fp2_to_ints(y)
    return [None if i else ((int(a), int(b)), (int(c), int(d)))
            for a, b, c, d, i in zip(x0, x1, y0, y1, inf.tolist())]


@pytest.mark.parametrize("group,name", [("g1", "scalar_mul"),
                                        ("g1", "scalar_mul_generic"),
                                        ("g2", "scalar_mul")])
def test_scalar_mul_matches_jax_projective(group, name):
    g = GROUPS[group]
    jp, tp, js, ts, pts, ks = smul_inputs(group)
    got = getattr(g["port"], name)(tp, ts)
    assert same_proj(group, got, getattr(g["jax"], name)(jp, js))
    assert affine_host(group, got) == [g["mul"](p, k) if p else None
                                       for p, k in zip(pts, ks)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_split_equals_generic_and_host(group):
    """GLV / GLS against the plain windows (G2's generic has no JAX call
    here) and the host oracle, on random full-width scalars."""
    g = GROUPS[group]
    ks = [rng.randrange(Q) for _ in range(5)] + [Q - 2, BLS_X ** 3 - 1]
    pts = [g["mul"](g["gen"], rng.randrange(1, Q)) for _ in ks]
    tp = g["to_torch"](numpy_tree(g["enc"]([g["proj"](p) for p in pts])),
                       "cpu")
    ts = limbs.from_ints(limbs.FR, ks, device="cpu")
    split = g["port"].scalar_mul(tp, ts)
    generic = g["port"].scalar_mul_generic(tp, ts)
    assert g["port"].eq(split, generic).all()
    assert affine_host(group, generic) == [g["mul"](p, k)
                                           for p, k in zip(pts, ks)]


def test_mul_by_const_schedule_and_sign():
    """A static k: a doubling per bit, an add per set bit, from the
    identity; n_bits pads leading zero bits; a negative k negates."""
    pts = [jhm.g1_mul(G1_GEN, rng.randrange(1, Q)) for _ in range(3)]
    tp = convert.g1_proj_to_torch(numpy_tree(
        GROUPS["g1"]["enc"]([g1_proj(p) for p in pts])), "cpu")
    for k, n_bits in ((0b1011001, None), (0b1011001, 10), (-77, None)):
        calls = collections.Counter()
        real = pe.plan_exec_plain

        def spy(ops, plan):
            calls[plan.name] += 1
            return real(ops, plan)

        pe.plan_exec_plain = spy
        try:
            got = g1.CURVE.mul_by_const(tp, k, n_bits)
        finally:
            pe.plan_exec_plain = real
        kk = abs(k)
        assert calls == {"g1_double_plan": n_bits or kk.bit_length(),
                         "g1_add_plan": bin(kk).count("1")}
        assert affine_host("g1", got) == [jhm.g1_mul(p, k) for p in pts]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bits_and_unsigned_windows_match_host(group):
    """The JAX package's other schedules: double-and-add over bit tensors
    (`scalar_mul_bits`) and Straus over unsigned 4-bit digits of unequal
    lengths (`multi_scalar_mul_windowed`, the shorter list left-padded)."""
    g = GROUPS[group]
    ks1 = [rng.randrange(1 << 40) for _ in range(3)] + [0]
    ks2 = [rng.randrange(1 << 20) for _ in range(3)] + [5]
    pts = [g["mul"](g["gen"], rng.randrange(1, Q)) for _ in range(3)] + [None]
    tp = g["to_torch"](numpy_tree(g["enc"]([g["proj"](p) for p in pts])),
                       "cpu")
    curve = g["port"].CURVE
    bits = torch.tensor([[(k >> (39 - i)) & 1 for k in ks1]
                         for i in range(40)], dtype=torch.bool)
    want1 = [g["mul"](p, k) if p else None for p, k in zip(pts, ks1)]
    assert affine_host(group, curve.scalar_mul_bits(tp, bits)) == want1
    d1 = limbs.digits4_msb(limbs.from_ints(limbs.FR, ks1, to_mont=False,
                                           device="cpu"), 40)
    d2 = limbs.digits4_msb(limbs.from_ints(limbs.FR, ks2, to_mont=False,
                                           device="cpu"), 20)
    q2 = curve.double(tp)
    got = curve.multi_scalar_mul_windowed([tp, q2], [d1, d2])
    assert affine_host(group, got) == [
        g["mul"](p, k1 + 2 * k2) if p else None
        for p, k1, k2 in zip(pts, ks1, ks2)]


def test_fr_bits_and_digits_match_jax():
    ks = EDGE_SCALARS + [rng.randrange(Q) for _ in range(8)]
    js = jfr.from_ints(ks)
    ts = convert.fr_to_torch(np.asarray(js), "cpu")
    assert np.array_equal(g1.fr_bits_msb(ts).numpy(),
                          np.asarray(jg1.fr_bits_msb(js)))
    assert np.array_equal(g1.fr_digits4_msb(ts).numpy(),
                          np.asarray(jg1.fr_digits4_msb(js)))


# --- the launch schedules of the scalar multiplication rows ---------------


def count_launches(fn, *args):
    """Run fn on CPU tensors, counting each plain version of a kernel the
    way its wrapper counts the kernel's launches on the card; returns
    (counts, fn's value)."""
    LAUNCHES.reset()
    names = [(mont, "sop_rows_plain"), (pe, "plan_exec_plain"),
             (mont, "pow_fixed_plain"), (mont, "sqr_plain"),
             (mont, "fp2_pow_plain"), (sha256, "sha256_plain"),
             (sha256, "expand_message_xmd_sha256_plain"),
             (keccak, "shake_plain")]
    real = [getattr(mod, name) for mod, name in names]

    def count(counter):
        setattr(LAUNCHES, counter, getattr(LAUNCHES, counter) + 1)

    def rows(spec, *a):
        count("sop_fr" if spec.n_limbs == 16 else
              "sop" if len(a[3]) == 1 else "fold_planned")
        return real[0](spec, *a)

    def plan(ops, p):
        LAUNCHES.plan_exec += 1
        LAUNCHES.plan_exec_by_plan[p.name] += 1
        return real[1](ops, p)

    def power(spec, a, e):
        count("pow_fixed_fr" if spec.n_limbs == 16 else "pow_fixed")
        return real[2](spec, a, e)

    def counted(i, counter):
        def call(*a, **k):
            count(counter)
            return real[i](*a, **k)
        return call

    fakes = [rows, plan, power, counted(3, "sqr"),
             counted(4, "fp2_pow_fixed"), counted(5, "sha256"),
             counted(6, "xmd_sha256"), counted(7, "shake")]
    for (mod, name), fake in zip(names, fakes):
        setattr(mod, name, fake)
    try:
        out = fn(*args)
    finally:
        for (mod, name), fn_real in zip(names, real):
            setattr(mod, name, fn_real)
    return LAUNCHES.snapshot(), out


@pytest.mark.parametrize("group,name", sorted(
    {(g, name) for g, name, _ in port_cases.SMUL_ROWS}))
def test_phase_smul_launch_schedules(group, name):
    n = 32
    if name == "scalar_mul":
        args = entry.smul_inputs(5, group, device="cpu")
    else:
        args = (entry.msm_inputs(5, group, device="cpu")[0],)
    fn = getattr({"g1": g1, "g2": g2, "gt": gt}[group], name)
    assert count_launches(fn, *args)[0] == \
        port_cases.expected_smul_launches(group, name, n)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_launch_schedules(group):
    """msm_g1 / msm_g2 (G2's three psi one fold each) against
    `port_cases.expected_msm_launches`."""
    fn, (pts, sc) = entry.msm_entry(5, group, device="cpu")
    assert count_launches(fn, pts, sc, 6)[0] == \
        port_cases.expected_msm_launches(group, 32, 6)


@pytest.mark.parametrize("group,name", sorted(
    {(g, name) for g, name, _ in chip_smoke.SMUL_ROWS}))
def test_phase_smul_row_calls_recorded(group, name):
    """The kernel timer (`chip_smoke.py`) replays every `sop_rows` call of
    each smul row: the calls `chip_smoke.record_rows` records, split by
    `chip_smoke.row_route`, are as many as the row's schedule launches on
    each route, and each replays to its plain value on the inputs
    `chip_smoke.smul_args` makes (128 lanes; 100 for batch_normalize)."""
    n = 100 if name == "batch_normalize" else 128
    args = chip_smoke.smul_args(group, name, n, torch.device("cpu"))
    fn = getattr({"g1": g1, "g2": g2, "gt": gt}[group], name)
    calls = chip_smoke.record_rows(lambda: fn(*args))
    want = port_cases.expected_smul_launches(group, name, n)
    got = collections.Counter(chip_smoke.row_route(c) for c in calls)
    assert {r: got[r] for r in ("sop", "fold_planned", "sop_fr")} == \
        {r: want[r] for r in ("sop", "fold_planned", "sop_fr")}
    for c in calls:
        assert torch.equal(mont.sop_rows(*c), mont.sop_rows_plain(*c))
