"""A Python-integer model of `csrc/mont_pow.cuh`'s `mont_pow_kernel`, the
Fp and Fr fixed-exponent power behind `mont.pow_fixed` and
`mont.pow_fixed_fr`, row for row and thread share by thread share, held to
the bounds its comments state and to the plain version and the host.

The CUDA kernel cannot run here; exact equality on the card rests on its
carry chains never losing a carry and on its lazy bound.  The model runs
the kernel's arithmetic on Python integers at a given TPI (threads per
lane; the library takes `mont.pow_threads_per_lane`'s, at the paths'
widths the field's most, POW_TPI or POW_TPI_FR, and 1 on a full card):
each thread's share of a lane's
Montgomery product (`mont_mul_share`: CIOS over 32-bit words, the thread's
n = W / TPI words of the multiplicand and the modulus, its even and odd
words in two accumulators, m broadcast from the lane's first thread, the
dropped low word sent to the thread below), the gather that adds the
threads' shares into one value, the Fr product's conditional subtraction,
and at TPI = 1 the square by `sqr_words` (off-diagonal products in two
chains, doubled, the diagonal, the reduction's rows).  It asserts that no
carry chain carries out of its last word, every bound the source states
(the accumulators' word counts, a share below 2^(32(n+1)), a Fp value
below 2p between steps, a Fr value canonical), then runs the 4-bit digit
schedule with the leading zero digits and the products by entry 0
skipped, and the one subtraction before the store.  A whole power at the
paths' TPI must equal `mont.pow_fixed_plain` (CPU) and pow(a, e, m) in
Montgomery form on the lanes 0, 1, m - 1, R mod m, R^2 mod m and 8 random
lanes from a numpy seed, at the exponents 1, 2, 15, 16, p - 2, (p + 1)/4,
q - 2 and Fr's square-root exponent (t - 1)/2, for both fields; at one
thread a lane (the full card's shape) on the five fixed lanes; every TPI
at the largest operands a step takes.

Tolerance: none (integers compare exactly).
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bls12_381_torch import limbs, params
from bls12_381_torch.kernels import mont

MASK = (1 << 32) - 1
T_FR = (params.Q - 1) >> params.FR_S          # q - 1 = 2^32 t, t odd


class Field:
    """mont_pow.cuh's field: W words, the modulus, N0 = -m^-1 mod 2^32,
    and whether a value may stay below 2m between steps (4m < R)."""

    def __init__(self, name, modulus, words, lazy):
        self.name, self.m, self.W, self.lazy = name, modulus, words, lazy
        self.R = 1 << (32 * words)
        self.N0 = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
        self.spec = limbs.FP if words == 12 else limbs.FR
        assert lazy == (4 * modulus < self.R)


FP = Field("fp", params.P, 12, True)
FR = Field("fr", params.Q, 8, False)


def words(x: int, n: int) -> list:
    return [(x >> (32 * i)) & MASK for i in range(n)]


def value(w) -> int:
    return sum(v << (32 * i) for i, v in enumerate(w))


def parity(x: int, n: int, odd: int) -> int:
    """The even (odd = 0) or odd (odd = 1) words of an n-word x, in place."""
    return value(w if j % 2 == odd else 0 for j, w in enumerate(words(x, n)))


def chain(acc: int, col: int, n_words: int, add: int) -> int:
    """acc + add, where one carry chain writes acc's words col ..
    col + n_words - 1 (mad_pairs): it must not carry out of its last
    word."""
    out = acc + add
    assert out < 1 << (32 * (col + n_words)), "carry out of a chain"
    return out


def shares(F: Field, tpi: int, y: int):
    """Thread k's even and odd words of y's words k n .. k n + n - 1, in
    place (n = W / tpi)."""
    n = F.W // tpi
    parts = [(y >> (32 * n * k)) & ((1 << (32 * n)) - 1) for k in range(tpi)]
    return [(parity(v, n, 0), parity(v, n, 1)) for v in parts]


@functools.cache
def modulus_shares(F: Field, tpi: int):
    return shares(F, tpi, F.m)


def mont_mul_share(F: Field, tpi: int, x: int, y: int) -> int:
    """mont_pow.cuh `mont_mul_share` on every thread of a lane, then the
    gather: (x y + M m) / R for x < R and y < R (the kernel's: x, y < 2m for
    Fp, < m for Fr), returned as one value.  Thread k holds y's and the
    modulus's words k n .. k n + n - 1 (n = W / tpi), their even words in
    accumulator A (madc_pairs, words 0 .. 2 ceil(n/2)) and their odd words
    in B (mad_pairs from word 1, words 0 .. 2 floor(n/2) + 1)."""
    W, n = F.W, F.W // tpi
    top_a = 1 << (32 * (2 * ((n + 1) // 2) + 1))  # no chain carries out
    top_b = 1 << (32 * (2 * (n // 2) + 2))
    bound = 1 << (32 * n + 2)                     # the stated bound
    top_recv = 1 << (32 * (n + 1))
    at_n1 = 32 * (n - 1)
    ys, ms = shares(F, tpi, y), modulus_shares(F, tpi)
    A, B, cin = [0] * tpi, [0] * tpi, [0] * tpi
    threads = range(tpi)
    for i in range(W):
        xi = (x >> (32 * i)) & MASK
        # thread 0's row first: m comes from its low words
        a0, b0 = A[0] + xi * ys[0][0] + cin[0], B[0] + xi * ys[0][1]
        m = ((a0 & MASK) + (b0 & MASK)) * F.N0 & MASK  # the broadcast
        low = [0] * tpi
        for k in threads:                         # the row, the reduction
            if k:
                a0, b0 = A[k] + xi * ys[k][0] + cin[k], B[k] + xi * ys[k][1]
            assert a0 < top_a and b0 < top_b
            a0 += m * ms[k][0]
            b0 += m * ms[k][1]
            assert a0 < top_a and b0 < top_b
            t = (a0 & MASK) + (b0 & MASK)
            low[k], cin[k] = t & MASK, t >> 32
            A[k], B[k] = a0 >> 32, b0 >> 32
        assert low[0] == 0                        # x[0] + y[0] = 0 mod 2^32
        for k in range(tpi - 1):                  # the word from above, at
            if n % 2 == 0:                        # word n - 1, carrying
                A[k] += low[k + 1] << at_n1       # into word n
                assert A[k] < top_recv
            else:
                B[k] += low[k + 1] << at_n1
                assert B[k] < top_recv
        for k in threads:
            assert A[k] < bound and B[k] < bound
    parts = [A[k] + B[k] + cin[k] for k in range(tpi)]
    assert all(s < bound for s in parts)          # add_words over n + 1
    assert parts[-1] < 1 << (32 * n)              # the top share's overflow
    r = sum(s << (32 * n * k) for k, s in enumerate(parts))
    assert r < F.R                                # the gather's add_words
    assert r * F.R % F.m == x * y % F.m
    return r


def sqr_words(F: Field, a: int) -> int:
    """mont_pow.cuh's TPI = 1 square (mont_sqr.cuh's `sqr_words` over W
    words): (a^2 + M m) / R for a < 2m (Fp) or a < m (Fr), without the
    final subtraction."""
    W = F.W
    w = words(a, W)
    A = B = 0
    for i in range(W - 1):                        # 1. off-diagonal rows
        n_a, n_b = (W - i) // 2, (W - 1 - i) // 2
        A = chain(A, 2 * i + 1, 2 * n_a + 1, sum(
            w[i] * w[i + 1 + 2 * j] << (32 * (2 * i + 1 + 2 * j))
            for j in range(n_a)))
        if n_b:
            B = chain(B, 2 * i + 2, 2 * n_b + 1, sum(
                w[i] * w[i + 2 + 2 * j] << (32 * (2 * i + 2 + 2 * j))
                for j in range(n_b)))
        limit = value(w[:i + 1]) << (32 * W)
        assert A <= limit and B <= limit
    assert A + B < 1 << (64 * W - 1)              # 2. doubling, diagonal
    t = 2 * (A + B) + sum(v * v << (64 * i) for i, v in enumerate(w))
    assert t == a * a < 1 << (64 * W)
    x, y, cin = t % F.R, 0, 0                     # 3. the reduction's rows
    m_even, m_odd = parity(F.m, W, 0), parity(F.m, W, 1)
    for _ in range(W):
        x += 1 if cin else 0
        mi = ((x & MASK) + (y & MASK)) * F.N0 & MASK
        x += mi * m_even
        y += mi * m_odd
        assert x < 1 << (32 * W + 1) and y < 1 << (32 * W + 33)
        low, cin = x & MASK, y & MASK
        assert low + cin == (1 << 32 if cin else 0)
        x, y = x >> 32, y >> 32
    q = x + y + (1 if cin else 0)
    assert q <= F.m
    s = q + (t >> (32 * W))
    assert s < F.R
    return s


def step(F: Field, tpi: int, x: int, y: int, square: bool) -> int:
    """One step of the chain: a product (x y, x from the table or the
    operand) or a square (x = y), lazy below 2m for Fp, canonical for Fr."""
    if F.lazy:
        assert x < 2 * F.m and y < 2 * F.m       # 4m^2 < mR: below 2m
    else:
        assert x < F.m and y < F.m               # m^2 < mR: below 2m
    r = sqr_words(F, y) if square and tpi == 1 else \
        mont_mul_share(F, tpi, x, y)
    assert r < 2 * F.m
    if not F.lazy and r >= F.m:                   # Fr: canonical each step
        r -= F.m
    return r


def pow_model(F: Field, tpi: int, a: int, exponent: int) -> int:
    """mont_pow_kernel on one lane: a^e R^(1-e) mod m, canonical, for a
    canonical a in Montgomery form."""
    assert a < F.m
    table = [F.R % F.m, a]
    for _ in range(2, 16):
        table.append(step(F, tpi, a, table[-1], False))
    digits = [int(d) for d in mont.pow_digits(exponent, F.m)]
    i = next((k for k, d in enumerate(digits) if d), len(digits))
    acc = table[digits[i] if i < len(digits) else 0]
    for d in digits[i + 1:]:
        for _ in range(4):
            acc = step(F, tpi, acc, acc, True)
        if d:
            acc = step(F, tpi, table[d], acc, False)
    out = acc - F.m if acc >= F.m else acc        # the store's subtraction
    assert out < F.m
    return out


FIELDS = {"fp": FP, "fr": FR}
EXPONENTS = {"1": 1, "2": 2, "15": 15, "16": 16, "p-2": params.P - 2,
             "(p+1)/4": (params.P + 1) // 4, "q-2": params.Q - 2,
             "(t-1)/2": (T_FR - 1) // 2}
_rng = np.random.default_rng(15)
LANE_NAMES = ["0", "1", "m-1", "R", "R^2"] + [f"random{i}" for i in range(8)]
RANDOM = {name: [int.from_bytes(_rng.bytes(48), "little") for _ in range(8)]
          for name in FIELDS}


def lane_value(F: Field, lane: str) -> int:
    fixed = {"0": 0, "1": 1, "m-1": F.m - 1, "R": F.R % F.m,
             "R^2": F.R * F.R % F.m}
    if lane in fixed:
        return fixed[lane]
    return RANDOM[F.name][int(lane[len("random"):])] % F.m


@functools.cache
def plain(field: str, exponent: str) -> list:
    """mont.pow_fixed_plain on every lane at once (CPU)."""
    F = FIELDS[field]
    n = F.spec.n_limbs
    a = torch.tensor([params.to_limbs(lane_value(F, v), n)
                      for v in LANE_NAMES], dtype=torch.int32).T.contiguous()
    with torch.inference_mode():  # the plain version's overhead: ~40 %
        out = mont.pow_fixed_plain(F.spec, a, EXPONENTS[exponent])
    return [params.from_limbs(out[:, j].tolist()) for j in range(out.shape[1])]


def check_power(field: str, exponent: str, lane: str, tpi: int) -> None:
    F, e = FIELDS[field], EXPONENTS[exponent]
    a = lane_value(F, lane)
    got = pow_model(F, tpi, a, e)
    r_inv = pow(F.R, -1, F.m)
    assert got == pow(a * r_inv, e, F.m) * F.R % F.m
    assert got == plain(field, exponent)[LANE_NAMES.index(lane)]


@pytest.mark.parametrize("lane", LANE_NAMES)
@pytest.mark.parametrize("exponent", list(EXPONENTS))
@pytest.mark.parametrize("field", list(FIELDS))
def test_model_matches_plain_and_host(field, exponent, lane):
    """At the paths' widths' threads per lane (1024 lanes)."""
    check_power(field, exponent, lane,
                mont.pow_threads_per_lane(FIELDS[field].spec, 1024))


@pytest.mark.parametrize("lane", LANE_NAMES[:5])
@pytest.mark.parametrize("exponent", list(EXPONENTS))
@pytest.mark.parametrize("field", list(FIELDS))
def test_one_thread_a_lane_matches_plain_and_host(field, exponent, lane):
    """At the full card's one thread a lane (2^16 lanes), where the square
    is `sqr_words_of`."""
    tpi = mont.pow_threads_per_lane(FIELDS[field].spec, 1 << 16)
    assert tpi == 1
    check_power(field, exponent, lane, tpi)


@pytest.mark.parametrize("tpi", [1, 2, 4])
@pytest.mark.parametrize("field", list(FIELDS))
def test_every_threads_per_lane_at_its_bounds(field, tpi):
    """The variants that scripts/pow_variants.py builds: a product and a
    square at the largest operands a step passes them (2m - 1 for Fp, m - 1
    for Fr), and a power at the inversion's exponent on one random lane."""
    F = FIELDS[field]
    top = 2 * F.m - 1 if F.lazy else F.m - 1
    for x, y in ((top, top), (top, 1), (1, top), (F.R % F.m, top)):
        step(F, tpi, x, y, False)
        step(F, tpi, y, y, True)
    a = lane_value(F, "random0")
    assert pow_model(F, tpi, a, F.m - 2) == pow(a, -1, F.m) * F.R * F.R % F.m


def test_launch_shape_matches_the_kernel_source():
    """mont.POW_TPI, POW_TPI_FR, POW_LANES and POW_FILL_THREADS, from which
    `pow_threads_per_lane` and chip_smoke.py's kernel timer take the
    launch shape, are
    mont_pow.cuh's kTpiFp, kTpiFr, kLanes and kFillThreads."""
    src = (Path(mont.__file__).parent / "csrc" / "mont_pow.cuh").read_text()
    for name, value in (("kTpiFp", mont.POW_TPI), ("kTpiFr", mont.POW_TPI_FR),
                        ("kLanes", mont.POW_LANES)):
        assert re.findall(rf"constexpr int {name} = (\d+);", src) == [
            str(value)]
    fill = re.findall(r"constexpr int kFillThreads = 1 << (\d+);", src)
    assert [1 << int(b) for b in fill] == [mont.POW_FILL_THREADS]


@pytest.mark.parametrize("B, fp, fr", [
    (1, 4, 2), (1024, 4, 2), (4096, 4, 2), (4097, 2, 2), (8192, 2, 2),
    (8193, 1, 1), (1 << 16, 1, 1)])
def test_threads_per_lane_by_width(B, fp, fr):
    """The width rule as measured on the card (PERF.md): the field's most
    threads a lane up to 4096 (Fp) or 8192 (Fr) lanes, 2 up to 8192 (Fp),
    then one."""
    assert mont.pow_threads_per_lane(limbs.FP, B) == fp
    assert mont.pow_threads_per_lane(limbs.FR, B) == fr
