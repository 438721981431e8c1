"""The port's square roots, signs, powers, hash_to_field reduction and Fp
byte codecs (`limbs.gt_half`/`sgn0`, `fields/fp.py`, `fields/tower.py`'s
`fp2_pow`/`fp2_sqrt`/`fp2_lexicographically_largest`/`fp2_sgn0`, the
plain version of the `fp2_pow_fixed` kernel in `kernels/mont.py`) against
the JAX package on the CPU.

Tolerance: none (integer arithmetic) -- limbs, masks and bytes compare
exactly.  Inputs: 0, 1, p-1, (p-1)/2, (p+1)/2, squares and non-squares,
then seeded random values (numpy or `random`, handed to both packages).
"""

import ast
import builtins
import pathlib
import random

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax.numpy as jnp
from bls12_381_tpu import hostmath as jhm
from bls12_381_tpu import limbs as jlimbs
from bls12_381_tpu.fields import fp as jfp, tower as jtw

from bls12_381_torch import convert, hostmath as hm, limbs
from bls12_381_torch.fields import fp, tower as tw
from bls12_381_torch.kernels import LAUNCHES, mont
from bls12_381_torch.params import P

torch.set_num_threads(1)
rng = random.Random(20261018)
np_rng = np.random.default_rng(20261018)

NON_SQUARES = [v for v in range(2, 40) if jhm.fp_sqrt(v) is None][:3]
FP_VALUES = [0, 1, P - 1, (P - 1) // 2, (P + 1) // 2, 4, 9] + NON_SQUARES + [
    rng.randrange(P) for _ in range(12)] + [
    rng.randrange(P) ** 2 % P for _ in range(6)]


def jax_fp(vals):
    return jfp.from_ints(vals)


def port(x):
    """A JAX Fp array (or a tuple of them) as the port's CPU tensors."""
    if isinstance(x, tuple):
        return tuple(port(t) for t in x)
    return convert.fp_to_torch(np.asarray(x), "cpu")


def same(got: torch.Tensor, want) -> bool:
    return np.array_equal(got.numpy().astype(np.int64),
                          np.asarray(want).astype(np.int64))


def test_gt_half_and_sgn0_match_jax():
    canon = jfp.from_ints(FP_VALUES, to_mont=False)
    t = port(canon)
    assert same(limbs.gt_half(limbs.FP, t), jlimbs.gt_half(jlimbs.FP, canon))
    assert same(limbs.sgn0(t), jlimbs.sgn0(canon))
    assert limbs.gt_half(limbs.FP, t).tolist() == [
        v > (P - 1) // 2 for v in FP_VALUES]


def test_fp_sqrt_matches_jax():
    a = jax_fp(FP_VALUES)
    root, ok = fp.sqrt(port(a))
    jroot, jok = jfp.sqrt(a)
    assert same(root, jroot) and same(ok, jok)
    assert ok.tolist() == [jhm.fp_sqrt(v) is not None for v in FP_VALUES]
    assert not ok[7:7 + len(NON_SQUARES)].any()


def test_fp_signs_match_jax():
    a = jax_fp(FP_VALUES)
    t = port(a)
    assert same(fp.lexicographically_largest(t),
                jfp.lexicographically_largest(a))
    assert same(fp.sgn0_mont(t), jfp.sgn0_mont(a))


def test_fp_pow_runtime_and_fixed_match_jax():
    """fp.pow with a runtime exponent (two limbs: 32 bits per lane) and
    fp.pow_fixed."""
    a = jax_fp(FP_VALUES[:8])
    exps = [0, 1, 2, 0xFFFFFFFF, 65537, 3, rng.randrange(1 << 32), 12345]
    e = jnp.asarray(np.array([[x & 0xFFFF for x in exps],
                              [x >> 16 for x in exps]], np.uint32))
    got = fp.pow(port(a), port(e))
    assert same(got, jfp.pow(a, e))
    assert [int(v) for v in fp.to_ints(got)] == [
        pow(v, x, P) for v, x in zip(FP_VALUES[:8], exps)]
    assert same(fp.pow_fixed(port(a), 0x1234567), jfp.pow_fixed(a, 0x1234567))


def test_pow_does_not_shadow_the_builtin():
    """A module of the port that defines `pow` (the JAX package's name for
    the runtime-exponent power) must not call the builtin's three-argument
    form once that def has bound the name: inside any function, or at
    module level below the def, `pow` is the module's own function (the
    JAX package's fr.sqrt broke on exactly that)."""
    assert fp.pow is not builtins.pow
    root = pathlib.Path(__file__).resolve().parent.parent / "bls12_381_torch"
    shadowing = []

    def calls(node):
        return [n.lineno for n in ast.walk(node) if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Name) and n.func.id == "pow"
                and len(n.args) != 2]

    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        defs = [n.lineno for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "pow"]
        if not defs:
            continue
        shadowing.append(path.name)
        bad = [ln for n in tree.body for ln in calls(n)
               if isinstance(n, (ast.FunctionDef, ast.ClassDef))
               or n.lineno > defs[0]]
        assert bad == [], f"{path.name} calls pow(x, e, m) at lines {bad}"
    assert sorted(shadowing) == ["fp.py", "fr.py"]
    # and the functions that need modular integer powers still run
    x = fp.from_ints([4, 5], device="cpu")
    assert fp.sqrt(x)[1].tolist() == [True, jhm.fp_sqrt(5) is not None]


def test_from_okm_matches_jax_and_host():
    okm = np_rng.integers(0, 256, (5, 64), dtype=np.uint8)
    okm[0] = 255  # the largest 512-bit value
    okm[1] = 0
    got = fp.from_okm(torch.from_numpy(okm))
    assert same(got, jfp.from_okm(jnp.asarray(okm)))
    assert same(fp.from_okm(okm, device="cpu"), jfp.from_okm(jnp.asarray(okm)))
    assert [int(v) for v in fp.to_ints(got)] == [
        hm.fp_from_okm(bytes(r)) for r in okm]


def test_fp_byte_codecs_match_jax():
    a = jax_fp(FP_VALUES)
    assert np.array_equal(fp.to_bytes_host(port(a)), jfp.to_bytes_host(a))
    data = np.array([v.to_bytes(48, "big") for v in FP_VALUES]
                    + [P.to_bytes(48, "big"), (P + 5).to_bytes(48, "big"),
                       b"\xff" * 48], dtype=object)
    raw = np.frombuffer(b"".join(data), np.uint8).reshape(len(data), 48)
    got, ok = fp.from_bytes_host(raw, device="cpu")
    jgot, jok = jfp.from_bytes_host(raw)
    assert np.array_equal(ok, np.asarray(jok))
    assert ok.tolist() == [True] * len(FP_VALUES) + [False] * 3
    assert same(got[:, ok], np.asarray(jgot)[:, ok])


# --- Fp2 ---------------------------------------------------------------------


FP2_EDGES = [(0, 0), (1, 0), (0, 1), (P - 1, P - 1), (0, P - 1), (P - 1, 0)]
FP2_VALUES = FP2_EDGES + [(rng.randrange(P), rng.randrange(P))
                          for _ in range(6)]
FP2_EXPONENTS = {"(p-3)/4": (P - 3) // 4, "(p-1)/2": (P - 1) // 2, "0": 0,
                 "1": 1, "2": 2}


def jax_fp2(vals):
    return jtw.fp2_from_ints(vals)


@pytest.mark.parametrize("name", list(FP2_EXPONENTS))
def test_fp2_pow_matches_jax(name):
    """`tw.fp2_pow` (the plain version of the kernel on the CPU) and
    `mont.fp2_pow_plain` against JAX `fp2_pow` and the host oracle."""
    e = FP2_EXPONENTS[name]
    a = jax_fp2(FP2_VALUES)
    want = jtw.fp2_pow(a, e)
    ta = port(a)
    LAUNCHES.reset()
    got = tw.fp2_pow(ta, e)
    assert LAUNCHES.fp2_pow_fixed == 0  # CPU tensors: the plain version
    assert same(got[0], want[0]) and same(got[1], want[1])
    plain = mont.fp2_pow_plain(ta[0], ta[1], e)
    assert same(plain[0], want[0]) and same(plain[1], want[1])
    g0, g1 = tw.fp2_to_ints(got)
    assert [(int(x), int(y)) for x, y in zip(g0, g1)] == [
        jhm.fp2_pow(v, e) for v in FP2_VALUES]


def test_fp2_pow_fixed_rejects_what_the_kernel_does_not_take():
    a = tw.fp2_from_ints([(1, 2)], device="cpu")
    for bad in (-1, 1.5, 1 << 1024):
        with pytest.raises(ValueError):
            mont.fp2_pow_fixed(a[0], a[1], bad)
    with pytest.raises(ValueError):
        mont.fp2_pow_fixed(a[0], a[1][:, :0], 3)
    with pytest.raises(ValueError):
        mont.fp2_pow_fixed(a[0].long(), a[1].long(), 3)
    with pytest.raises(ValueError):
        mont.fp2_pow_fixed(a[0][:16], a[1][:16], 3)


def test_fp2_sqrt_matches_jax_and_root_choice():
    """Roots and masks of JAX `fp2_sqrt`, on squares (the general branch),
    the alpha = -1 branch's subfield values (the reference's root-choice
    vector b = 5, tests/test_device_fields.py:253), zero and non-squares;
    roots equal the host oracle's deterministic root."""
    cases = [jhm.fp2_square(v) for v in FP2_VALUES[6:]]
    cases += [(5, 0), (25, 0), (7, 0), (1, 0), (4, 0), (0, 0)]
    cases += [v for v in FP2_VALUES[6:] if jhm.fp2_sqrt(v) is None][:2]
    a = jax_fp2(cases)
    root, ok = tw.fp2_sqrt(port(a))
    jroot, jok = jtw.fp2_sqrt(a)
    assert same(root[0], jroot[0]) and same(root[1], jroot[1])
    assert same(ok, jok)
    r0, r1 = tw.fp2_to_ints(root)
    for i, c in enumerate(cases):
        want = jhm.fp2_sqrt(c)
        assert bool(ok[i]) == (want is not None), c
        if want is not None:
            assert (int(r0[i]), int(r1[i])) == want, c


def test_fp2_signs_match_jax():
    a = jax_fp2(FP2_VALUES)
    t = port(a)
    assert same(tw.fp2_lexicographically_largest(t),
                jtw.fp2_lexicographically_largest(a))
    assert same(tw.fp2_sgn0(t), jtw.fp2_sgn0(a))
    assert tw.fp2_sgn0(t).tolist() == [bool(jhm.fp2_sgn0(v))
                                       for v in FP2_VALUES]
