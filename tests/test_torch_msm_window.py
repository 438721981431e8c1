"""The port's G1 MSM at the default window c = 12 (bls12_381_torch.ops.msm)
on the CPU against the JAX package's host oracle (`bls12_381_tpu.hostmath`):
its serial fold sum_i [k_i] P_i, with the GLV split and with the plain
255-bit digits.

Tolerance: none (integer arithmetic) -- the port's projective result,
decoded by the JAX package's `to_ints` and a host inversion, equals the
oracle's affine point exactly.  Inputs are seeded multiples of the generator
and seeded scalars.
"""

import random

import pytest
import torch

import conftest  # noqa: F401
from bls12_381_tpu import hostmath as jhm
from bls12_381_tpu.fields import fp as jfp
from bls12_381_tpu.params import G1_GEN, P, Q

from bls12_381_torch import convert
from bls12_381_torch.curves import g1
from bls12_381_torch.fields import fp, fr
from bls12_381_torch.ops import msm

torch.set_num_threads(1)
rng = random.Random(31)


@pytest.mark.parametrize("glv", [True, False])
def test_msm_g1_production_window(glv):
    """c = 12: digits that straddle limbs, 2^11 buckets located by
    searchsorted, a lane count that is not a power of two."""
    n = 96
    ks = [rng.randrange(Q) for _ in range(n)]
    pts = [jhm.g1_mul(G1_GEN, rng.randrange(1, 1 << 20)) for _ in range(n)]
    tp = g1.from_affine((fp.from_ints([p[0] for p in pts], device="cpu"),
                         fp.from_ints([p[1] for p in pts], device="cpu"),
                         torch.zeros(n, dtype=torch.bool)))
    got = msm.msm_g1(tp, fr.from_ints(ks, device="cpu"), c=12, glv=glv)
    expected = None
    for k, p in zip(ks, pts):
        expected = jhm.g1_add(expected, jhm.g1_mul(p, k))
    x, y, z = (int(jfp.to_ints(c)) for c in convert.g1_proj_from_torch(got))
    assert z != 0
    zi = pow(z, -1, P)
    assert (x * zi % P, y * zi % P) == expected
