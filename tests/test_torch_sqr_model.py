"""A Python-integer model of `csrc/mont_sqr.cuh`'s `sqr_words` (the body
of `sqr_kernel`, behind `mont.sqr`), row for row, held to the bounds its
comments state and to the plain version and the host.

The CUDA kernel cannot run here; exact equality on the card rests on its
carry chains never losing a carry.  The model runs the kernel's rows on
32-bit words: each off-diagonal `mad_pairs` chain (products a_i a_j with
j - i odd into A from column 2i + 1, j - i even into B from column 2i + 2),
asserting that no chain carries out of its last word and that A and B stay
below the stated 2^(32(i + 13)) after row i; A + B, the doubling and the
diagonal squares, asserting t = a^2; the Montgomery reduction's rows (m
from the low words and the dropped words' carry, m p's even and odd words
in two accumulators), asserting the stated x < 2^385 and y < 2^417 in a row
and the dropped words' sum 0 or 2^32; then the high half and the one
conditional subtraction, asserting the sum < 2p.  The result must equal
`mont.sqr_plain` (CPU) and a^2 R^-1 mod p on the host, on the lanes 0, 1,
p - 1, R mod p, R^2 mod p and 8 random lanes from a numpy seed.

Tolerance: none (integers compare exactly).
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bls12_381_torch import params
from bls12_381_torch.kernels import mont

P = params.P
W = 12
R = 1 << 384
N0 = 0xFFFCFFFD                       # -p^-1 mod 2^32 (carry_chain.cuh kN0)
R_INV = pow(R, -1, P)
MASK = (1 << 32) - 1


def words(x: int, n: int = W) -> list:
    return [(x >> (32 * i)) & MASK for i in range(n)]


def value(w) -> int:
    return sum(v << (32 * i) for i, v in enumerate(w))


def mad_pairs(acc: list, col: int, x: int, y: list) -> None:
    """carry_chain.cuh `mad_pairs<len(y)>` at acc[col..]: acc += x (y[0] +
    y[1] 2^64 + ...) (y: the words two apart), one carry chain ending in
    acc[col + 2 len(y)], which must not carry out."""
    c = 0
    for k, yk in enumerate(y):
        lo, hi = (x * yk) & MASK, (x * yk) >> 32
        for j, part in ((col + 2 * k, lo), (col + 2 * k + 1, hi)):
            s = acc[j] + part + c
            acc[j], c = s & MASK, s >> 32
    top = col + 2 * len(y)
    s = acc[top] + c
    assert s >> 32 == 0, f"carry out of word {top}"
    acc[top] = s


def even(y: int) -> int:
    return sum(w << (32 * j) for j, w in enumerate(words(y)) if j % 2 == 0)


def odd(y: int) -> int:
    return sum(w << (32 * j) for j, w in enumerate(words(y)) if j % 2 == 1)


def sqr_model(a_int: int) -> int:
    """sqr_words on one lane: a^2 R^-1 mod p, canonical, for a < p."""
    assert 0 <= a_int < P
    a = words(a_int)
    # 1. off-diagonal rows
    A, B = [0] * (2 * W), [0] * (2 * W)
    for i in range(W - 1):
        mad_pairs(A, 2 * i + 1, a[i], a[i + 1::2][:(W - i) // 2])
        if (W - 1 - i) // 2:
            mad_pairs(B, 2 * i + 2, a[i], a[i + 2::2][:(W - 1 - i) // 2])
        # the stated bound: each below (sum_{r<=i} a_r 2^(32 r)) 2^384
        limit = value(a[:i + 1]) << 384
        assert value(A) <= limit < 1 << (32 * (i + 13))
        assert value(B) <= limit
    off = value(A) + value(B)
    assert off == sum(a[i] * a[j] << (32 * (i + j))
                      for i in range(W) for j in range(i + 1, W))
    # 2. add_words_carry twice, the doubling, mad_squares twice
    assert off < 1 << 761
    t = 2 * off + sum(a[i] * a[i] << (64 * i) for i in range(W))
    assert t == a_int * a_int < 1 << 762
    # 3. the reduction's rows over the low half
    x, y, cin = t % R, 0, 0
    p_even, p_odd = even(P), odd(P)
    for _ in range(W):
        x += 1 if cin else 0                      # madc_row's carry in
        m = ((x & MASK) + (y & MASK)) * N0 & MASK
        x += m * p_even
        y += m * p_odd
        assert x < 1 << 385 and y < 1 << 417      # x[W] <= 1, y[W+1] <= 1
        low, cin = x & MASK, y & MASK
        assert low + cin == (1 << 32 if cin else 0)  # x[0] + y[0] = 0
        x, y = x >> 32, y >> 32
    q = x + y + (1 if cin else 0)                  # add_words with cin
    assert q <= P
    s = q + (t >> 384)                             # add_words of the high half
    assert s < 2 * P
    r = s - P if s >= P else s                     # sub_words and the select
    return r


_rng = np.random.default_rng(14)
LANES = {"0": 0, "1": 1, "p-1": P - 1, "R": R % P, "R^2": R * R % P} | {
    f"random{i}": int.from_bytes(_rng.bytes(48), "little") % P
    for i in range(8)}


@functools.cache
def plain() -> dict:
    """mont.sqr_plain on every lane at once (CPU), G = 1."""
    a = torch.tensor([params.to_limbs(v, 24) for v in LANES.values()],
                     dtype=torch.int32).T.contiguous()[None]
    out = mont.sqr_plain(a)[0]
    return {k: params.from_limbs(out[:, j].tolist())
            for j, k in enumerate(LANES)}


@pytest.mark.parametrize("lane", list(LANES))
def test_model_matches_plain_and_host(lane):
    a = LANES[lane]
    got = sqr_model(a)
    assert got == a * a * R_INV % P
    assert got == plain()[lane]


def test_launch_shape_matches_the_kernel_source():
    """mont.SQR_THREADS and SQR_LANES_PER_THREAD, from which chip_smoke.py's
    kernel timer prints the launch shape, are mont_sqr.cuh's kThreads and
    kLanesPerThread."""
    src = (Path(mont.__file__).parent / "csrc" / "mont_sqr.cuh").read_text()
    assert re.findall(r"constexpr int kThreads = (\d+);", src) == [
        str(mont.SQR_THREADS)]
    assert re.findall(r"constexpr int kLanesPerThread = (\d+);", src) == [
        str(mont.SQR_LANES_PER_THREAD)]
