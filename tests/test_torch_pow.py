"""The port's fixed-exponent powers (`limbs.pow_fixed`, `fp.inv`, `fr.inv`
and the plain version of the `pow_fixed` / `pow_fixed_fr` kernels in
kernels/mont.py) against the JAX package's `pow_fixed` / `inv` on the CPU.

Tolerance: none (integer arithmetic) -- every comparison is exact equality
of 16-bit limbs, of digit lists or of Python integers.  Inputs: the edge
lanes 0, 1, 2, m-1, m-2 and R mod m, then lanes from a seeded numpy
generator, for m = p (Fp) and m = q (Fr).  Each JAX result is computed once
per (field, exponent) and shared by the tests that read it.
"""

import functools

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax
import jax.extend as jex
from bls12_381_tpu import limbs as jlb
from bls12_381_tpu.fields import fp as jfp
from bls12_381_tpu.fields import fr as jfr

from bls12_381_torch import convert, limbs
from bls12_381_torch.fields import fp, fr
from bls12_381_torch.kernels import LAUNCHES, mont
from bls12_381_torch.params import P, Q

torch.set_num_threads(1)
np_rng = np.random.default_rng(20261016)

EXPONENTS = {
    "1": 1, "2": 2, "15": 15, "16": 16, "0x1234567": 0x1234567,
    "(p+1)/4": (P + 1) // 4, "p-2": P - 2, "q-2": Q - 2,
    # wider than p, under the kernel's 1024-bit cap
    "wide": (P << 17) + 0x1234567,
}
# Fr runs the same kernel code (each JAX reference costs ~3 s to trace and
# compile): a dense exponent, one wider than q ((p+1)/4) and the inverse
FR_EXPONENTS = ("0x1234567", "(p+1)/4", "q-2")


class Field:
    def __init__(self, spec, jspec, jfield, to_torch, from_torch, n_bytes):
        m = spec.modulus
        r = 1 << (16 * spec.n_limbs)
        self.spec, self.jspec, self.jfield = spec, jspec, jfield
        self.from_torch = from_torch
        self.vals = [0, 1, 2, m - 1, m - 2, r % m] + [
            int.from_bytes(np_rng.bytes(n_bytes), "little") % m
            for _ in range(10)]
        self.jax = jfield.from_ints(self.vals)
        self.port = to_torch(np.asarray(self.jax), "cpu")  # [L, 16]


FIELDS = {
    "fp": Field(limbs.FP, jlb.FP, jfp, convert.fp_to_torch,
                convert.fp_from_torch, 48),
    "fr": Field(limbs.FR, jlb.FR, jfr, convert.fr_to_torch,
                convert.fr_from_torch, 32),
}


_RUNNERS = {}  # jaxpr text -> jitted evaluation with the constants as data


@functools.cache
def jax_pow(field: str, exponent: int):
    """(JAX a^exponent as numpy, the digits its scan runs over): `inv` for
    the field's own m - 2, `pow_fixed` otherwise, traced to a jaxpr whose
    one scan over a constant (the reductions scan over nothing) reads the
    digit list.  Exponents of one field and digit count trace to the same
    jaxpr but for that constant, so the jaxpr is compiled once with its
    constants as arguments and run on each exponent's digits."""
    f = FIELDS[field]
    if exponent == f.spec.modulus - 2:
        fn = f.jfield.inv
    else:
        fn = functools.partial(jlb.pow_fixed, f.jspec, exponent=exponent)
    closed = jax.make_jaxpr(fn)(f.jax)
    consts = dict(zip(closed.jaxpr.constvars, closed.consts))
    digits = [np.asarray(consts[v]) for eqn in closed.jaxpr.eqns
              if eqn.primitive.name == "scan"
              for v in eqn.invars[eqn.params["num_consts"]
                                  + eqn.params["num_carry"]:]
              if v in consts]
    assert len(digits) == 1
    jaxpr = closed.jaxpr
    run = _RUNNERS.setdefault(str(jaxpr), jax.jit(
        lambda cs, x: jex.core.jaxpr_as_fun(
            jex.core.ClosedJaxpr(jaxpr, cs))(x)))
    out = run(list(closed.consts), f.jax)[0]
    return np.asarray(out), digits[0]


def host_pow(f: Field, exponent: int):
    return [pow(x, exponent, f.spec.modulus) for x in f.vals]


@pytest.mark.parametrize("field,name",
                         [("fp", n) for n in EXPONENTS]
                         + [("fr", n) for n in FR_EXPONENTS])
def test_pow_fixed_matches_jax(field, name):
    """limbs.pow_fixed over a [L, 2, 8] batch equals the JAX package's
    pow_fixed on every lane, and the host's pow; the kernel's digit encoder
    gives the digit list the JAX scan runs over."""
    f, e = FIELDS[field], EXPONENTS[name]
    ref, digits = jax_pow(field, e)
    enc = mont.pow_digits(e, f.spec.modulus)
    assert enc.dtype == np.uint8 and np.array_equal(enc, digits)
    L = f.spec.n_limbs
    got = limbs.pow_fixed(f.spec, f.port.reshape(L, 2, 8), e)
    assert got.shape == (L, 2, 8) and got.dtype == limbs.DTYPE
    assert np.array_equal(f.from_torch(got.reshape(L, 16)), ref)
    assert [int(v) for v in limbs.to_ints(f.spec, got.reshape(L, 16))] \
        == host_pow(f, e)


@pytest.mark.parametrize("field", list(FIELDS))
def test_inv_matches_jax_in_one_kernel_call(field, monkeypatch):
    """fp.inv / fr.inv equal the JAX package's inv, through exactly one
    call of the field's power wrapper (its plain version here: no launch
    is counted on the CPU)."""
    f = FIELDS[field]
    name = {"fp": "pow_fixed", "fr": "pow_fixed_fr"}[field]
    real, calls = getattr(mont, name), []

    def spy(a, exponent, *args):
        calls.append((tuple(a.shape), exponent))
        return real(a, exponent, *args)

    monkeypatch.setattr(mont, name, spy)
    LAUNCHES.reset()
    m = f.spec.modulus
    got = {"fp": fp, "fr": fr}[field].inv(f.port)
    assert calls == [((f.spec.n_limbs, 16), m - 2)]
    assert LAUNCHES.snapshot()[name] == 0
    assert np.array_equal(f.from_torch(got), jax_pow(field, m - 2)[0])
    vals = [int(v) for v in limbs.to_ints(f.spec, got)]
    assert vals[0] == 0 and all(v * x % m == 1
                                for v, x in zip(vals[1:], f.vals[1:]))


@pytest.mark.parametrize("field", list(FIELDS))
def test_pow_fixed_plain_matches_jax(field):
    """mont.pow_fixed_plain (the JAX schedule over the plain products) at
    0x1234567 and at 0 (every digit 0: the JAX package returns one)."""
    f = FIELDS[field]
    e = EXPONENTS["0x1234567"]
    got = mont.pow_fixed_plain(f.spec, f.port, e)
    assert np.array_equal(f.from_torch(got), jax_pow(field, e)[0])
    zero_exp = mont.pow_fixed_plain(f.spec, f.port, 0)
    assert np.array_equal(f.from_torch(zero_exp),
                          np.asarray(jlb.pow_fixed(f.jspec, f.jax, 0)))
    assert torch.equal(limbs.pow_fixed(f.spec, f.port, 0), zero_exp)
    assert np.array_equal(mont.pow_digits(0, f.spec.modulus),
                          np.zeros(-(-f.spec.modulus.bit_length() // 4)))


@pytest.mark.parametrize("field", list(FIELDS))
def test_pow_fixed_window_argument(field):
    """`window=4`, the JAX package's default, is the kernel's digit width:
    the call equals the one without it and the JAX package's value; any
    other window raises ValueError (a tensor on any device: the check comes
    before the kernel and its plain version)."""
    f, e = FIELDS[field], EXPONENTS["0x1234567"]
    got = limbs.pow_fixed(f.spec, f.port, e, window=4)
    assert torch.equal(got, limbs.pow_fixed(f.spec, f.port, e))
    assert np.array_equal(f.from_torch(got), jax_pow(field, e)[0])
    for window in (3, 5):
        for x in (f.port, f.port.to("meta")):
            with pytest.raises(ValueError, match="window"):
                limbs.pow_fixed(f.spec, x, e, window=window)
    with pytest.raises(ValueError, match="window"):
        limbs.pow_fixed(f.spec, f.port, 0, window=3)


def test_digit_encoder_widths():
    """The encoder pads to the modulus's width in whole digits, widens for
    a wider exponent, and reaches the kernel's cap at 1024 bits."""
    assert len(mont.pow_digits(1, P)) == 96
    assert len(mont.pow_digits(1, Q)) == 64
    assert list(mont.pow_digits(0xAB, Q)[-2:]) == [0xA, 0xB]
    assert len(mont.pow_digits((P << 17) + 1, P)) == 100
    top = mont.pow_digits((1 << 1024) - 1, P)
    assert len(top) == mont.POW_DIGITS and set(top.tolist()) == {15}


BAD_CALLS = {
    "exponent over the cap": (lambda x: x, 1 << 1024),
    "negative exponent": (lambda x: x, -3),
    "float exponent": (lambda x: x, 3.0),
    "batch axis missing": (lambda x: x[:, 0], 5),
    "stacked operand": (lambda x: x.unsqueeze(0), 5),
    "int64 limbs": (lambda x: x.long(), 5),
    "limbs of the other field": (lambda x: x[:8], 5),
    "neither CPU nor CUDA": (lambda x: x.to("meta"), 5),
}


@pytest.mark.parametrize("case", list(BAD_CALLS))
@pytest.mark.parametrize("wrapper", ["pow_fixed", "pow_fixed_fr"])
def test_wrappers_raise_value_error(wrapper, case):
    f = FIELDS["fp" if wrapper == "pow_fixed" else "fr"]
    bend, exponent = BAD_CALLS[case]
    with pytest.raises(ValueError):
        getattr(mont, wrapper)(bend(f.port), exponent)
