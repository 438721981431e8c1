"""The port's Gt (`pairing/gt.py`), `tower.fp12_pow` and host pairing
(`hostmath`) on the CPU, held to the host oracles: the port's `hostmath`
and the JAX package's (the JAX device Gt is a heavy-tier graph,
tests/test_pairing.py:115, so the host pairing stands in for it).

Tolerance: none (integer arithmetic) -- Fp12 values compare as host
integers, batches limb for limb.
"""

import random

import pytest
import torch

import conftest  # noqa: F401
from bls12_381_tpu import hostmath as jhm

from bls12_381_torch import hostmath as hm, limbs
from bls12_381_torch.fields import tower as tw
from bls12_381_torch.pairing import gt
from bls12_381_torch.params import BLS_X, G1_GEN, G2_GEN, P, Q

torch.set_num_threads(1)
rng = random.Random(12)

SCALARS = [987654321987654321, 0, 1, Q - 1, BLS_X ** 2, BLS_X ** 3 + 5]


def host_lanes(f, n):
    """A port Fp12 batch -> n host Fp12 values (nested int tuples)."""
    h = tw.fp12_to_host(f)
    return [tuple(tuple((int(c[0][i]), int(c[1][i])) for c in c6)
                  for c6 in h) for i in range(n)]


def from_host(vals):
    """Host Fp12 values -> one port batch on the CPU."""
    return tuple(tuple(tw.fp2_from_ints([v[i][j] for v in vals],
                                        device="cpu")
                       for j in range(3)) for i in range(2))


def rand_fp12():
    return tuple(tuple((rng.randrange(P), rng.randrange(P))
                       for _ in range(3)) for _ in range(2))


def scalars(ks):
    return limbs.from_ints(limbs.FR, ks, device="cpu")


@pytest.mark.parametrize("e", [0, 1, 2, 5, 0x1234567, BLS_X])
def test_fp12_pow_matches_host(e):
    vals = [rand_fp12() for _ in range(3)]
    got = host_lanes(tw.fp12_pow(from_host(vals), e), 3)
    assert got == [jhm.fp12_pow(v, e) for v in vals]


def test_host_pairing_matches_jax_hostmath():
    a, b = rng.randrange(1, 1 << 20), rng.randrange(1, 1 << 20)
    for p, q in ((G1_GEN, G2_GEN),
                 (hm.g1_mul(G1_GEN, a), hm.g2_mul(G2_GEN, b)),
                 (None, G2_GEN)):
        assert hm.pairing(p, q) == jhm.pairing(p, q)
    gen = hm.gt_generator()
    assert gen == jhm.pairing(G1_GEN, G2_GEN)
    # bilinear: e([a]G1, [b]G2) = e(G1, G2)^(a b); of order q
    assert hm.pairing(hm.g1_mul(G1_GEN, a), hm.g2_mul(G2_GEN, b)) == \
        hm.fp12_pow(gen, a * b)
    assert hm.fp12_pow(gen, Q) == hm.FP12_ONE
    assert hm.fp12_frobenius(gen) == jhm.fp12_frobenius(gen)
    assert hm.fp12_mul(gen, hm.fp12_inv(gen)) == hm.FP12_ONE


def test_generator_and_group_law():
    g = gt.generator((3,), device="cpu")
    assert host_lanes(g, 3) == [jhm.pairing(G1_GEN, G2_GEN)] * 3
    assert gt.is_identity(gt.sub(g, g)).all()
    assert not gt.is_identity(g).any()
    assert gt.is_identity(gt.identity((2,), device="cpu")).all()
    assert gt.eq(gt.double(g), gt.add(g, g)).all()
    assert host_lanes(gt.neg(g), 1) == [
        jhm.fp12_pow(jhm.pairing(G1_GEN, G2_GEN), Q - 1)]
    assert host_lanes(gt.frobenius(g), 1) == [
        jhm.fp12_pow(jhm.pairing(G1_GEN, G2_GEN), P % Q)]
    mask = torch.tensor([True, False, True])
    picked = gt.select(mask, g, gt.identity((3,), device="cpu"))
    assert gt.is_identity(picked).tolist() == [False, True, False]


def test_generator_takes_the_jax_keyword():
    """`generator(batch_shape=...)`, the JAX package's keyword."""
    g = gt.generator(batch_shape=(2,), device="cpu")
    assert g[0][0][0].shape == (24, 2)
    assert host_lanes(g, 2) == [jhm.pairing(G1_GEN, G2_GEN)] * 2


@pytest.mark.parametrize("name", ["scalar_mul", "scalar_mul_generic"])
def test_scalar_mul_matches_host(name):
    """A batchless generator broadcast over the scalars' lanes (the
    expanded views go through the Frobenius folds in place)."""
    g = gt.generator(device="cpu")
    out = getattr(gt, name)(g, scalars(SCALARS))
    want = [jhm.fp12_pow(jhm.pairing(G1_GEN, G2_GEN), k) for k in SCALARS]
    assert host_lanes(out, len(SCALARS)) == want


def test_split_equals_generic_on_random_elements():
    """Random elements of Gt (powers of the generator) and full-width
    scalars: the GLS split and the ladder agree lane for lane."""
    gen = hm.gt_generator()
    base = from_host([hm.fp12_pow(gen, rng.randrange(1, Q))
                      for _ in range(4)])
    ks = scalars([rng.randrange(Q) for _ in range(4)])
    assert gt.eq(gt.scalar_mul(base, ks),
                 gt.scalar_mul_generic(base, ks)).all()


def test_cyclotomic_sqr_k_is_four_single_squarings():
    """scalar_mul's doublings run as ONE fp12_cyclotomic_sqr_k(4) plan; its
    canonical outputs equal four single cyclotomic squarings (the JAX
    package's gt doubling) limb for limb."""
    gen = hm.gt_generator()
    f = from_host([hm.fp12_pow(gen, rng.randrange(Q)) for _ in range(5)]
                  + [hm.FP12_ONE])
    single = f
    for _ in range(4):
        single = gt.double(single)
    chained = tw.fp12_cyclotomic_sqr_k(f, 4)
    assert all(a.equal(b) for a, b in zip(
        [t for c6 in chained for c2 in c6 for t in c2],
        [t for c6 in single for c2 in c6 for t in c2]))
    assert host_lanes(chained, 6) == [hm.fp12_pow(v, 16) for v in
                                      host_lanes(f, 6)]
