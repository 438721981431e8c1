"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Tolerance: none (integer arithmetic) -- kernel and plain version must agree
limb for limb.  Every test here needs a CUDA device: without one it skips
(the `gpu` marker; the decision is taken in a fixture, never at import).
On a machine with a card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

(`--noconftest`: the suite's conftest imports JAX, which the port's
machine need not have.)
"""

import pytest
import torch

from bls12_381_torch import entry, limbs, params
from bls12_381_torch.kernels import LAUNCHES, mont, plan_exec as pe

pytestmark = pytest.mark.gpu
P = params.P
EDGES = (0, 1, P - 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def rand_limbs(n: int, lanes: int, device, seed: int) -> torch.Tensor:
    """[n, 24, lanes] random canonical limbs; lanes 0..2 of every row hold
    0, 1 and p-1 (with every row p-1 in lane 2: the carry edge case)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 1 << 16, (n, 24, lanes), generator=gen,
                      dtype=torch.int32)
    x[:, 23] %= limbs.FP.p_limbs[23]
    for lane, v in enumerate(EDGES):
        x[:, :, lane] = torch.tensor(params.to_limbs(v, 24))
    return x.to(device)


@pytest.mark.parametrize("T", [1, 2, 5, 8])
def test_sop_kernel_matches_plain(cuda, T):
    a = rand_limbs(T, 333, cuda, seed=T)
    b = rand_limbs(T, 333, cuda, seed=100 + T)
    got = mont.sop(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), mont.sop_plain(a.cpu(), b.cpu()))


@pytest.mark.parametrize("G", [1, 3])
def test_sqr_kernel_matches_plain(cuda, G):
    a = rand_limbs(G, 257, cuda, seed=7 + G)
    got = mont.sqr(a)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), mont.sqr_plain(a.cpu()))


@pytest.mark.parametrize("make_plan", pe.MAIN_PATH_PLANS,
                         ids=lambda b: pe.compile_plan(b()).name)
def test_plan_kernel_matches_plain(cuda, make_plan):
    plan = pe.compile_plan(make_plan())
    ops = rand_limbs(plan.n_in, 130, cuda, seed=plan.n_slots)
    got = pe.plan_exec(ops, plan)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), pe.plan_exec_plain(ops.cpu(), plan))


def test_pairing_on_card_matches_cpu(cuda):
    fn, (p, q) = entry.entry(batch=2)
    assert p[0].device.type == "cuda"
    LAUNCHES.reset()
    out = fn(p, q)
    torch.cuda.synchronize()
    counts = LAUNCHES.snapshot()
    assert min(counts["sop"], counts["sqr"], counts["plan_exec"]) > 0

    def to_cpu(x):
        return tuple(to_cpu(y) for y in x) if isinstance(x, tuple) \
            else x.cpu()

    ref = fn(to_cpu(p), to_cpu(q))
    for g6, r6 in zip(out, ref):
        for g2, r2 in zip(g6, r6):
            for g, r in zip(g2, r2):
                assert torch.equal(g.cpu(), r)
