"""The port's NTT slice (bls12_381_torch.ops.ntt, entry.ntt_entry,
convert's Fr codecs) against the JAX package's `ops.ntt` on the CPU.

Tolerance: none (integer arithmetic) -- the port's transforms must equal
the JAX package's limb for limb, and the evaluations Python's integers.
Coefficients come from a seeded numpy generator and cross between the
packages as numpy.
"""

import random

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax.numpy as jnp
from bls12_381_tpu.fields import fr as jfr
from bls12_381_tpu.ops import ntt as jntt

from bls12_381_torch import convert, entry, params
from bls12_381_torch.fields import fr
from bls12_381_torch.kernels import LAUNCHES
from bls12_381_torch.ops import ntt

torch.set_num_threads(1)
Q = params.Q
rng = random.Random(99)


def coeffs_np(shape, seed):
    """Random canonical Fr limbs [16, *shape] (top limb below q's)."""
    g = np.random.default_rng(seed)
    x = g.integers(0, 1 << 16, (16,) + tuple(shape), dtype=np.uint32)
    x[15] &= 0x3FFF
    return x


def same(port, jax_arr):
    return np.array_equal(convert.fr_from_torch(port), np.asarray(jax_arr))


@pytest.mark.parametrize("inverse", [False, True], ids=["ntt", "intt"])
@pytest.mark.parametrize("shape", [(32,), (64,), (3, 64)],
                         ids=["32", "64", "3x64"])
def test_ntt_matches_jax(shape, inverse):
    x = coeffs_np(shape, seed=len(shape) * 100 + shape[-1])
    got = ntt.ntt(convert.fr_to_torch(x, "cpu"), inverse=inverse)
    assert got.shape == (16,) + shape
    assert same(got, jntt.ntt(jnp.asarray(x), inverse=inverse))


def test_ntt_evaluates_and_inverts():
    """As tests/test_ops.py: ntt(c)[k] = sum_i c_i omega^(ik), and intt
    inverts it."""
    n = 32
    coeffs = [rng.randrange(Q) for _ in range(n)]
    evals = ntt.ntt(fr.from_ints(coeffs, device="cpu"))
    omega = pow(params.FR_ROOT_OF_UNITY, 1 << (params.FR_S - 5), Q)
    got = [int(v) for v in fr.to_ints(evals)]
    for k in range(n):
        assert got[k] == sum(c * pow(omega, i * k, Q)
                             for i, c in enumerate(coeffs)) % Q, k
    assert [int(v) for v in fr.to_ints(ntt.intt(evals))] == coeffs


def test_poly_mul_matches_jax_and_convolution():
    a = [3, 1, 4, 1, Q - 1]
    b = [2, 7, 1]
    got = ntt.poly_mul(fr.from_ints(a, device="cpu"),
                       fr.from_ints(b, device="cpu"))
    assert same(got, jntt.poly_mul(jfr.from_ints(a), jfr.from_ints(b)))
    exp = [0] * 8
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            exp[i + j] = (exp[i + j] + x * y) % Q
    assert [int(v) for v in fr.to_ints(got)] == exp


def test_convert_round_trips_fr_arrays():
    x = coeffs_np((2, 5), seed=7)
    j = jnp.asarray(x)
    t = convert.fr_to_torch(j, "cpu")
    assert t.dtype == torch.int32 and t.shape == (16, 2, 5)
    back = convert.fr_from_torch(t)
    assert back.dtype == np.uint32 and np.array_equal(back, x)
    assert [int(v) for v in fr.to_ints(t[:, 1])] == [
        int(v) for v in jfr.to_ints(j[:, 1])]
    with pytest.raises(ValueError, match="16"):
        convert.fr_to_torch(np.zeros((24, 3), np.uint32), "cpu")
    with pytest.raises(ValueError, match="16"):
        convert.fr_from_torch(torch.zeros((24, 3), dtype=torch.int32))


def test_ntt_entry_on_the_cpu():
    LAUNCHES.reset()
    fn, (x,) = entry.ntt_entry(5, device="cpu")
    assert fn is ntt.ntt and x.shape == (16, 32) and x.device.type == "cpu"
    vals = [int(v) for v in fr.to_ints(x)]
    assert all(0 <= v < Q for v in vals)
    out = fn(x)
    omega = pow(params.FR_ROOT_OF_UNITY, 1 << (params.FR_S - 5), Q)
    got = [int(v) for v in fr.to_ints(out)]
    for k in (0, 1, 31):
        assert got[k] == sum(c * pow(omega, i * k, Q)
                             for i, c in enumerate(vals)) % Q
    # the CPU path launches no kernel
    assert LAUNCHES.snapshot()["butterfly"] == LAUNCHES.snapshot()["sop_fr"] == 0
    # seeded: the same seed gives the same coefficients
    assert torch.equal(entry.ntt_inputs(5, batch=(2,), seed=1, device="cpu"),
                       entry.ntt_inputs(5, batch=(2,), seed=1, device="cpu"))


def test_ntt_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.ntt_entry()
    with pytest.raises(ValueError, match="power of two"):
        ntt.ntt(torch.zeros((16, 12), dtype=torch.int32))
