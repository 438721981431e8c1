"""The rest of the public surface of the ported modules on the CPU, against
the JAX package: `tower.fp2_mul_fp`, `fp2_sop`, `fp6_mul_by_0`,
`fp6_mul_by_12`, `fp12_add`, `pairing.pairing_batched`, and
`utils/profiling.trace`.

Tolerance: none (integer arithmetic) -- field elements compare limb for
limb with the JAX tower's (eager jnp on the CPU), pairings with the host
oracle (the JAX `pairing_batched` compiles for minutes on the CPU, so that
comparison is `heavy`).  Elements are seeded random with the edge values 0,
1 and p - 1, 4 lanes, made by the JAX package's encoders and handed over as
numpy.
"""

import json
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from bls12_381_tpu import hostmath as jhm
from bls12_381_tpu.fields import fp as jfp, tower as jtw
from bls12_381_tpu.params import G1_GEN, G2_GEN, P

from bls12_381_torch import convert, entry
from bls12_381_torch import pairing as pr
from bls12_381_torch.fields import tower as tw
from bls12_381_torch.utils import profiling

torch.set_num_threads(1)
rng = random.Random(909)
EDGES = (0, 1, P - 1)


def fp_vals():
    return list(EDGES) + [rng.randrange(P)]


def jfp2():
    return tuple(np.asarray(c) for c in jtw.fp2_from_ints(
        list(zip(fp_vals(), fp_vals()[::-1]))))


def jfp6():
    return (jfp2(), jfp2(), jfp2())


def port(tree):
    """numpy limbs of a nested tuple -> the port's CPU tensors."""
    if isinstance(tree, tuple):
        return tuple(port(t) for t in tree)
    return convert.fp_to_torch(tree, "cpu")


def jx(tree):
    if isinstance(tree, tuple):
        return tuple(jx(t) for t in tree)
    return jnp.asarray(tree)


def same(got, want) -> bool:
    """A port nested tuple of tensors equals a JAX one, limb for limb."""
    if isinstance(got, tuple):
        return len(got) == len(want) and all(
            same(g, w) for g, w in zip(got, want))
    return np.array_equal(convert.fp_from_torch(got), np.asarray(want))


def test_fp2_mul_fp():
    a, s = jfp2(), np.asarray(jfp.from_ints(fp_vals()))
    assert same(tw.fp2_mul_fp(port(a), port(s)),
                jtw.fp2_mul_fp(jx(a), jnp.asarray(s)))


@pytest.mark.parametrize("n_terms", [1, 2, 3, 4])
def test_fp2_sop(n_terms):
    terms = [(jfp2(), jfp2()) for _ in range(n_terms)]
    assert same(tw.fp2_sop([(port(x), port(y)) for x, y in terms]),
                jtw.fp2_sop([(jx(x), jx(y)) for x, y in terms]))


def test_fp2_sop_refuses_more_than_four_terms():
    a = port(jfp2())
    with pytest.raises(ValueError, match="1 to 4 terms"):
        tw.fp2_sop([(a, a)] * 5)


def test_fp6_mul_by_0():
    a, g0 = jfp6(), jfp2()
    assert same(tw.fp6_mul_by_0(port(a), port(g0)),
                jtw.fp6_mul_by_0(jx(a), jx(g0)))


def test_fp6_mul_by_12():
    a, g1, g2 = jfp6(), jfp2(), jfp2()
    assert same(tw.fp6_mul_by_12(port(a), port(g1), port(g2)),
                jtw.fp6_mul_by_12(jx(a), jx(g1), jx(g2)))


def test_fp12_add():
    a, b = (jfp6(), jfp6()), (jfp6(), jfp6())
    assert same(tw.fp12_add(port(a), port(b)), jtw.fp12_add(jx(a), jx(b)))


def test_pairing_batched_is_the_elementwise_pairing():
    p, q = entry.tiny_pairing_inputs(2, "cpu")
    f = pr.pairing_batched(p, q)
    for i in range(2):
        want = jhm.pairing(jhm.g1_mul(G1_GEN, i + 1),
                           jhm.g2_mul(G2_GEN, 2 * i + 1))
        got = tuple(tuple((int(c[0][i]), int(c[1][i])) for c in c6)
                    for c6 in tw.fp12_to_host(f))
        assert got == want


@pytest.mark.heavy
def test_pairing_batched_matches_jax():
    from bls12_381_tpu import pairing as jpr

    p, q = entry.tiny_pairing_inputs(2, "cpu")
    want = jpr.pairing_batched(
        jx(convert.g1_affine_from_torch(p)),
        jx(convert.g2_affine_from_torch(q)))
    assert same(pr.pairing_batched(p, q), want)


def test_time_fn_and_trace(tmp_path):
    """`trace()` writes the torch trace and, beside it, the program's spans
    recorded inside it."""
    with profiling.trace(str(tmp_path)):
        with profiling.span("sum"):
            torch.ones(4).sum()
    spans = json.loads((tmp_path / profiling.SPANS_FILE).read_text())
    assert [s["name"] for s in spans["spans"]] == ["sum"]
    assert len(list(tmp_path.glob("*.json"))) == 2
