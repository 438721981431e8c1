"""A Python-integer model of `csrc/fp2_pow.cuh`'s `fp2_pow_kernel`, step
for step, held to the bounds its comments state and to the plain versions.

The CUDA kernel cannot run here; exact equality on the card rests on its
bound argument (a product or sum below 8p^2 reduces below 2p with no
subtraction, and neither carry-chain accumulator overflows its words).  The
model runs the kernel's own arithmetic on Python integers: the two threads'
coordinate formulas (thread t holds `mine` = coordinate t and `other` = the
neighbour's), the 4-bit digit schedule with the leading zero digits skipped,
every lazy step, and the word-level Montgomery product (`mont_sum`: even
and odd word products in two accumulators, the reduction's row in the same
two, the dropped low words' carry), asserting each stated bound.  Its
result must equal `hostmath.fp2_pow` and `mont.fp2_pow_plain` (CPU) at both
of the Fp2 square root's exponents on every edge lane of
`port_cases.FP2_EDGE_LANES` and 8 random lanes.

Tolerance: none (integers compare exactly).
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import port_cases
from bls12_381_torch import hostmath, params
from bls12_381_torch.kernels import mont

P = params.P
R = 1 << 384
N0 = 0xFFFCFFFD                       # -p^-1 mod 2^32 (fp2_pow.cuh kN0)
R_INV = pow(R, -1, P)
ONE = R % P                           # entry 0's first coordinate
MASK = (1 << 32) - 1
EXPONENTS = {"(p-3)/4": (P - 3) // 4, "(p-1)/2": (P - 1) // 2}


def word(x: int, i: int) -> int:
    return (x >> (32 * i)) & MASK


def even(y: int) -> int:
    """The even words of y in place (mad_row's y[0], y[2], .., y[10])."""
    return sum(word(y, j) << (32 * j) for j in range(0, 12, 2))


def odd(y: int) -> int:
    return sum(word(y, j) << (32 * j) for j in range(1, 12, 2))


P_EVEN, P_ODD = even(P), odd(P)


def mont_sum(terms) -> int:
    """fp2_pow.cuh `mont_sum`: (sum of x y) R^-1 mod p in [0, 2p) for one
    or two (x, y) terms whose sum is < 8p^2, row by row as the kernel
    runs it."""
    assert sum(x * y for x, y in terms) < 8 * P * P
    assert all(x < R and y < R for x, y in terms)
    split = [([word(x, i) for i in range(12)], even(y), odd(y))
             for x, y in terms]
    a = b = cin = 0
    for i in range(12):
        for k, (x, y_even, y_odd) in enumerate(split):
            if i == 0 and k == 0:  # row 0 of the first term: multiplies
                a, b = x[0] * y_even, x[0] * y_odd
                continue
            # madc_row carries the dropped words' 1 into a[0]
            a += x[i] * y_even + (1 if k == 0 and cin else 0)
            b += x[i] * y_odd
        m = ((a & MASK) + (b & MASK)) * N0 & MASK
        a += m * P_EVEN
        b += m * P_ODD
        assert a < 1 << 386 and b < 1 << 418      # the stated bounds
        low_a, cin = a & MASK, b & MASK
        assert low_a + cin == (1 << 32 if cin else 0)  # A[0] + B[0] = 0
        a, b = a >> 32, b >> 32
    r = a + b + (1 if cin else 0)                 # add_words with cin
    assert r < 2 * P
    assert r % P == sum(x * y for x, y in terms) * R_INV % P
    return r


def sqr_step(t: int, mine: int, other: int) -> int:
    """Thread t's coordinate of (a0 + a1 u)^2: (a0 + a1)(a0 - a1) on
    thread 0, (a0 + a0) a1 on thread 1."""
    assert mine < 2 * P and other < 2 * P
    x = other + (other if t else mine)
    assert x < 4 * P                              # add_words: no carry out
    d = mine - other
    d += 2 * P if d < 0 else 0
    assert 0 <= d < 2 * P
    return mont_sum([(x, mine if t else d)])


def mul_step(t: int, mine: int, other: int, b0: int, b1: int) -> int:
    """Thread t's coordinate of (a0 + a1 u)(b0 + b1 u): a0 b0 + (2p - a1) b1
    on thread 0, a1 b0 + a0 b1 on thread 1."""
    assert max(mine, other, b0, b1) < 2 * P
    v = 2 * P - other
    assert 0 < v <= 2 * P                         # sub_words: no borrow
    return mont_sum([(mine, b0), (other if t else v, b1)])


def pair(step, acc, *entry):
    """One step on both threads of a lane, then the exchange."""
    return step(0, acc[0], acc[1], *entry), step(1, acc[1], acc[0], *entry)


def fp2_pow_model(a0: int, a1: int, exponent: int):
    """fp2_pow_kernel on one lane (Montgomery form in and out)."""
    assert a0 < P and a1 < P
    table = [(ONE, 0), (a0, a1)]
    for _ in range(2, 16):
        table.append(pair(mul_step, table[-1], a0, a1))
    digits = [int(d) for d in mont.pow_digits(exponent, P)]
    i = next((k for k, d in enumerate(digits) if d), len(digits))
    acc = table[digits[i] if i < len(digits) else 0]
    for d in digits[i + 1:]:
        for _ in range(4):
            acc = pair(sqr_step, acc)
        if d:
            acc = pair(mul_step, acc, *table[d])
    out = tuple(c - P if c >= P else c for c in acc)
    assert all(c < P for c in out)
    return out


VALUE = {"0": 0, "1": 1, "p-1": P - 1, "R": ONE}
_rng = np.random.default_rng(13)
LANES = [(VALUE[x], VALUE[y]) for x, y in port_cases.FP2_EDGE_LANES] + [
    tuple(int.from_bytes(_rng.bytes(48), "little") % P for _ in range(2))
    for _ in range(8)]
LANE_IDS = [f"edge{i}" for i in range(len(port_cases.FP2_EDGE_LANES))] + [
    f"random{i}" for i in range(8)]


@functools.cache
def plain(label: str):
    """mont.fp2_pow_plain on every lane at once (CPU): [(c0, c1)]."""
    a0, a1 = (torch.tensor([params.to_limbs(v[k], 24) for v in LANES],
                           dtype=torch.int32).T.contiguous()
              for k in range(2))
    c0, c1 = mont.fp2_pow_plain(a0, a1, EXPONENTS[label])
    return [(params.from_limbs(c0[:, j].tolist()),
             params.from_limbs(c1[:, j].tolist())) for j in range(len(LANES))]


def test_edge_lanes_cover_the_bound_cases():
    """The edge lanes hold the cases the bounds turn on: zero, one, p - 1
    and R mod p in either coordinate."""
    assert {(P - 1, 1), (1, P - 1), (ONE, 0), (P - 1, P - 1)} <= set(LANES)


@pytest.mark.parametrize("lane", range(len(LANES)), ids=LANE_IDS)
@pytest.mark.parametrize("label", list(EXPONENTS))
def test_model_matches_hostmath_and_plain(label, lane):
    a0, a1 = LANES[lane]
    got = fp2_pow_model(a0, a1, EXPONENTS[label])
    # hostmath works on plain values: Montgomery form is x R mod p
    want = hostmath.fp2_pow((a0 * R_INV % P, a1 * R_INV % P),
                            EXPONENTS[label])
    assert got == tuple(c * R % P for c in want)
    assert got == plain(label)[lane]


@pytest.mark.parametrize("terms", [
    [(4 * P - 1, 2 * P - 1)],                     # the square's largest
    [(2 * P - 1, 2 * P - 1), (2 * P, 2 * P - 1)],  # the product's largest
    [(2 * P - 1, 0), (2 * P, 2 * P - 1)],
    [(R - 1, 7)],                                 # every bit of x set
], ids=["square", "product", "product_half", "wide_words"])
def test_mont_sum_at_its_bounds(terms):
    """mont_sum's inputs at the largest values the steps pass it."""
    mont_sum(terms)


def test_wrapper_takes_the_plain_path_on_the_cpu():
    """A CPU tensor runs the plain version (the kernel runs on the card
    only)."""
    a0, a1 = (torch.tensor([params.to_limbs(v[k], 24) for v in LANES[:4]],
                           dtype=torch.int32).T.contiguous()
              for k in range(2))
    got = mont.fp2_pow_fixed(a0, a1, 5)
    want = mont.fp2_pow_plain(a0, a1, 5)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_lanes_per_block_match_the_kernel_source():
    """mont.FP2_POW_LANES, from which chip_smoke.py's kernel timer prints
    the launch shape, is fp2_pow.cuh's kLanes."""
    src = (Path(mont.__file__).parent / "csrc" / "fp2_pow.cuh").read_text()
    lanes = re.findall(r"constexpr int kLanes = (\d+);", src)
    assert lanes == [str(mont.FP2_POW_LANES)]
