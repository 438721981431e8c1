"""The port's batched pairing (bls12_381_torch.pairing) on the CPU, as a
whole slice, against the JAX package.

Tolerance: none (integer arithmetic) -- every comparison is exact equality
of field elements.

  - the full pairing against the RELIC-validated host oracle
    `bls12_381_tpu.hostmath.pairing`, identity lanes included;
  - `prepare_g2` coefficients and the Miller value against a pure-Python
    chain of the JAX package's `eval_plan_host` over its own step plans
    (device Miller values are scaled projectively and differ from
    `hostmath.miller_loop`; they agree only after the final exponentiation);
  - one `heavy` test against the JAX `pairing.pairing` (minutes of XLA CPU
    compile, so outside the default tier).

Inputs are seeded; points cross from the JAX package's encoding as numpy
via `bls12_381_torch.convert`.
"""

import importlib
import json
import random

import numpy as np
import pytest
import torch

import conftest
import jax.numpy as jnp
from bls12_381_tpu import hostmath as hm
from bls12_381_tpu.fields import fp as jfp, tower as jtw
from bls12_381_tpu.kernels import plan_exec as jpe
from bls12_381_tpu.params import G1_GEN, G2_GEN, P, Q

from bls12_381_torch import convert, entry
from bls12_381_torch import pairing as pr
from bls12_381_torch.fields import fp, tower as tw

torch.set_num_threads(1)
jpm = importlib.import_module("bls12_381_tpu.pairing.pairing")

R = 1 << 384
RINV = pow(R, -1, P)
rng = random.Random(11)
B = 4
AV = [1, 2, rng.randrange(Q), rng.randrange(Q)]
BV = [1, 3, rng.randrange(Q), rng.randrange(Q)]
PHS = [hm.g1_mul(G1_GEN, a) for a in AV]
QHS = [hm.g2_mul(G2_GEN, b) for b in BV]


def jax_points(p_inf=(False,) * B, q_inf=(False,) * B):
    """The JAX package's affine encodings of PHS / QHS, as numpy."""
    p = (np.asarray(jfp.from_ints([p[0] for p in PHS])),
         np.asarray(jfp.from_ints([p[1] for p in PHS])), np.array(p_inf))
    q = (tuple(np.asarray(c) for c in jtw.fp2_from_ints([q[0] for q in QHS])),
         tuple(np.asarray(c) for c in jtw.fp2_from_ints([q[1] for q in QHS])),
         np.array(q_inf))
    return p, q


def port_points(p_inf=(False,) * B, q_inf=(False,) * B):
    p, q = jax_points(p_inf, q_inf)
    return (convert.g1_affine_to_torch(p, "cpu"),
            convert.g2_affine_to_torch(q, "cpu"))


def lane(f, i):
    """Lane i of a port Fp12 batch as the host oracle's nested tuples."""
    return tuple(tuple((int(c2[0][i]), int(c2[1][i])) for c2 in c6)
                 for c6 in tw.fp12_to_host(f))


def raw(t: torch.Tensor):
    """[L, *batch] limbs -> numpy object array of raw (Montgomery) ints."""
    return fp.to_ints(t, from_mont=False)


def test_pairing_matches_host_oracle():
    out = pr.pairing(*port_points())
    for i in range(B):
        assert lane(out, i) == hm.pairing(PHS[i], QHS[i]), i
    relic = json.loads((conftest.VECTORS / "ref_constants.json").read_text())[
        "relic_pairing_fp12"]
    flat = [c for c6 in lane(out, 0) for c2 in c6 for c in c2]
    assert flat == [int(v, 16) for v in relic]


def test_identity_masking():
    """Identity on either side gives Fp12 one; both masks in one batch."""
    p_inf, q_inf = (True, False, False, True), (False, True, False, False)
    out = pr.pairing(*port_points(p_inf, q_inf))
    for i in range(B):
        exp = hm.pairing(None if p_inf[i] else PHS[i],
                         None if q_inf[i] else QHS[i])
        assert lane(out, i) == exp, i


def _host_prepare(xq, yq):
    """68 (a, b, c) coefficient triples of one lane, raw Montgomery ints,
    by chaining the JAX step plans through eval_plan_host."""
    one = R % P
    t = [xq[0], xq[1], yq[0], yq[1], one, 0]
    coeffs = []
    for is_add in jpm._IS_ADD_STEP:
        if is_add:
            out = jpe.eval_plan_host(jpe.g2_add_step_plan(),
                                     t + [xq[0], xq[1], yq[0], yq[1]], P, R)
        else:
            out = jpe.eval_plan_host(jpe.g2_dbl_step_plan(), t, P, R)
        coeffs.append(out[:6])
        t = out[6:]
    return coeffs


def test_prepare_g2_matches_jax_plan_chain():
    """Including an identity lane, which prepares the generator."""
    q_inf = (False, False, True, False)
    _, q = port_points(q_inf=q_inf)
    prep = pr.prepare_g2(q)
    assert prep.coeffs.shape == (68, 3, 2, 24, B)
    assert torch.equal(prep.infinity, torch.tensor(q_inf))
    got = raw(prep.coeffs.reshape(68, 6, 24, B).permute(2, 0, 1, 3))
    gen_m = [[c * R % P for c in xy] for xy in G2_GEN]
    for i in range(B):
        xq, yq = gen_m if q_inf[i] else [[c * R % P for c in xy]
                                         for xy in QHS[i]]
        exp = _host_prepare(xq, yq)
        assert got[:, :, i].tolist() == exp, i


def test_miller_loop_matches_jax_plan_chain():
    """Line scaling, identity masking and the 68 fused steps, against the
    JAX step plans chained through eval_plan_host."""
    p_inf = (False, True, False, False)
    p, q = port_points(p_inf=p_inf)
    prep = pr.prepare_g2(q)
    f = pr.miller_loop_batched(p, prep)
    coeffs = raw(prep.coeffs.reshape(68, 6, 24, B).permute(2, 0, 1, 3))
    xp, yp = raw(p[0]), raw(p[1])
    got = raw(torch.stack([c for c6 in f for c2 in c6 for c in c2], dim=1))
    one = R % P
    for i in range(B):
        acc = [one] + [0] * 11
        for step, sqr in enumerate(jpm._SQR_FLAGS):
            a0, a1, b0, b1, c0, c1 = (int(v) for v in coeffs[step, :, i])
            if p_inf[i]:
                line = [one, 0, 0, 0, 0, 0]
            else:
                line = [a0 * yp[i] * RINV % P, a1 * yp[i] * RINV % P, b0, b1,
                        c0 * xp[i] * RINV % P, c1 * xp[i] * RINV % P]
            plan = jpe.fp12_sqr_mul_by_045_plan() if sqr else \
                jpe.fp12_mul_by_045_plan()
            acc = jpe.eval_plan_host(plan, acc + line, P, R)
        exp = acc[:6] + [(-v) % P for v in acc[6:]]  # conjugate: z < 0
        assert got[:, i].tolist() == exp, i


def test_multi_miller_loop_and_final_exponentiation():
    """The tree product over an odd batch, then the final exponentiation of
    an unbatched element."""
    p, q = port_points()
    p3 = tuple(x[..., :3] for x in p)
    q3 = (tuple(x[..., :3] for x in q[0]), tuple(x[..., :3] for x in q[1]),
          q[2][:3])
    agg = pr.final_exponentiation(pr.multi_miller_loop(p3, pr.prepare_g2(q3)))
    acc = hm.FP12_ONE
    for i in range(3):
        acc = hm.fp12_mul(acc, hm.miller_loop(PHS[i], QHS[i]))
    got = tuple(tuple((int(c2[0]), int(c2[1])) for c2 in c6)
                for c6 in tw.fp12_to_host(agg))
    assert got == hm.final_exponentiation(acc)


def test_convert_round_trips():
    jp, jq = jax_points((True, False, False, False), (False, False, True,
                                                      False))
    for got, exp in ((convert.g1_affine_from_torch(
                          convert.g1_affine_to_torch(jp, "cpu")), jp),
                     (convert.g2_affine_from_torch(
                          convert.g2_affine_to_torch(jq, "cpu")), jq)):
        for g, e in zip(_leaves(got), _leaves(exp)):
            assert g.dtype == e.dtype and np.array_equal(g, e)
    prep = pr.prepare_g2(convert.g2_affine_to_torch(jq, "cpu"))
    coeffs, inf = convert.g2_prepared_from_torch(prep)
    assert coeffs.dtype == np.uint32 and coeffs.shape == (68, 3, 2, 24, B)
    back = convert.g2_prepared_to_torch(coeffs, inf, "cpu")
    assert torch.equal(back.coeffs, prep.coeffs)
    assert torch.equal(back.infinity, prep.infinity)
    f12 = tuple(tuple(tuple(np.asarray(c) for c in jtw.fp2_from_ints(
        [(k + 2 * j + i, k) for k in range(B)])) for j in range(3))
        for i in range(2))
    back12 = convert.fp12_from_torch(convert.fp12_to_torch(f12, "cpu"))
    assert all(np.array_equal(g, e)
               for g, e in zip(_leaves(back12), _leaves(f12)))
    with pytest.raises(ValueError):
        convert.fp_to_torch(np.full((24, 1), 1 << 16, np.uint32), "cpu")


def _leaves(x):
    return [y for v in x for y in (_leaves(v) if isinstance(v, tuple)
                                   else [v])]


def test_entry_on_cpu():
    fn, (p_aff, q_aff) = entry.entry(batch=2, device="cpu")
    assert p_aff[0].device.type == "cpu"
    out = fn(p_aff, q_aff)
    for i in range(2):
        exp = hm.pairing(hm.g1_mul(G1_GEN, i + 1),
                         hm.g2_mul(G2_GEN, 2 * i + 1))
        assert lane(out, i) == exp, i


@pytest.mark.heavy
def test_pairing_matches_jax_pairing():
    from bls12_381_tpu import pairing as jpr

    p_inf, q_inf = (False, True, False, False), (False, False, False, True)
    jp, jq = jax_points(p_inf, q_inf)
    exp = jpr.pairing(
        (jnp.asarray(jp[0]), jnp.asarray(jp[1]), jnp.asarray(jp[2])),
        (tuple(map(jnp.asarray, jq[0])), tuple(map(jnp.asarray, jq[1])),
         jnp.asarray(jq[2])))
    got = pr.pairing(convert.g1_affine_to_torch(jp, "cpu"),
                     convert.g2_affine_to_torch(jq, "cpu"))
    for g, e in zip(convert.fp12_from_torch(got),
                    tuple(tuple(tuple(np.asarray(c) for c in c2) for c2 in c6)
                          for c6 in exp)):
        for g2, e2 in zip(g, e):
            for gc, ec in zip(g2, e2):
                assert np.array_equal(gc, ec)
