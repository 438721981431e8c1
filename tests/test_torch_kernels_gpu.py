"""The port's CUDA kernels against their plain PyTorch versions, and its
paths on the card against the CPU path, the host oracle and their launch
schedules (`port_cases.expected_*_launches`), on the card.

Each kernel at the paths' shapes and edge values, the wide launches held on
sampled lanes; the row kernel also on the calls of whole paths as they make
them; the paths at small widths against the CPU path and at the benchmark's
and the library's widths against `hostmath` (the RELIC pairing vector, the
host's [sum_i k_i (i+1)]G of msm_g1_large up to 2^24 points, the scalar
multiplication, codec and hash to curve rows), the sharded paths on one
NCCL rank and on four gloo ranks sharing cuda:0.

Tolerance: none (integer arithmetic) -- kernel and plain version must agree
limb for limb.  Every test here needs a CUDA device: without one it skips
(the `gpu` marker; the decision is taken in a fixture, never at import).
On a machine with a card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

(`--noconftest`: the suite's conftest imports JAX, which the port's
machine need not have.)
"""

import collections
import hashlib
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import port_cases as pc
from bls12_381_torch import entry, hostmath as hm, limbs, params
from bls12_381_torch import pairing as pr
from bls12_381_torch.curves import g1, g2
from bls12_381_torch.fields import fp, fr, tower as tw
from bls12_381_torch.pairing import gt
from bls12_381_torch.kernels import (LAUNCHES, keccak, mont,
                                     plan_exec as pe, sha256)
from bls12_381_torch.ops import msm, ntt
from bls12_381_torch.utils import graphs, native, scans

pytestmark = pytest.mark.gpu
P, Q = params.P, params.Q
EDGES = (0, 1, P - 1)
VECTORS = Path(__file__).parent / "vectors"


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


def held_lanes(B: int, device, seed: int = 0):
    """The lanes of a launch over B lanes that its plain version is held
    to: every lane up to 2^16, beyond the first and the last 512 and 1024
    random ones (the plain version's int64 partial products at the full
    width would not fit)."""
    if B <= 1 << 16:
        return torch.arange(B, device=device)
    gen = torch.Generator().manual_seed(seed)
    return torch.unique(torch.cat([
        torch.arange(512), torch.arange(B - 512, B),
        torch.randint(0, B, (1024,), generator=gen)])).to(device)


# (T, B): 333 lanes (ragged blocks) at the paths' term counts, the
# pairing's batch, the MSM's 2^16 and msm_g1_large's chunk width (held on
# sampled lanes)
SOP_CASES = [pytest.param(T, 333, id=str(T)) for T in (1, 2, 5, 8)] + [
    pytest.param(T, B, id=f"{T}-{B}")
    for T, B in ((6, 1024), (8, 1 << 16), (1, 1 << 21))]


@pytest.mark.parametrize("T,B", SOP_CASES)
def test_sop_kernel_matches_plain(cuda, T, B):
    """Lanes 0..2 every operand 0, 1, p-1 (lane 2 at T = 8 the
    all-(p-1) carry case), lane 3 1 x (p-1), lane 4 (p-1) x 0."""
    a = rand_limbs(T, B, cuda, seed=T)
    b = rand_limbs(T, B, cuda, seed=100 + T)
    one, top = (torch.tensor(params.to_limbs(v, 24), device=cuda)
                for v in (1, P - 1))
    a[:, :, 3], b[:, :, 3] = one, top
    a[:, :, 4], b[:, :, 4] = top, 0
    got = mont.sop(a, b)
    lanes = held_lanes(B, cuda)
    assert torch.equal(got.index_select(-1, lanes), mont.sop_plain(
        a.index_select(-1, lanes), b.index_select(-1, lanes)))


SQR_EDGES = ((1 << 384) % P, (1 << 768) % P)  # R and R^2 mod p


@pytest.mark.parametrize("B", [1, 33, 257, 1024, 1 << 16])
@pytest.mark.parametrize("G", [1, 3])
def test_sqr_kernel_matches_plain(cuda, G, B):
    """mont_sqr.cuh's kernel at port_cases.SQR_WIDTHS' narrower widths;
    lanes 0..4 the edges 0, 1, p-1, R mod p, R^2 mod p (B > 5; else
    random lanes)."""
    a = rand_limbs(G, B + 8, cuda, seed=7 + G + B)
    for lane, v in enumerate(SQR_EDGES, start=len(EDGES)):
        a[:, :, lane] = torch.tensor(params.to_limbs(v, 24))
    a = (a[..., :B] if B > 5 else a[..., -B:]).contiguous()
    LAUNCHES.reset()
    got = mont.sqr(a)
    torch.cuda.synchronize()
    assert LAUNCHES.sqr == 1
    assert torch.equal(got.cpu(), mont.sqr_plain(a.cpu()))


@pytest.mark.parametrize("G", [1, 3])
def test_sqr_kernel_at_2_20_matches_plain_on_sampled_lanes(cuda, G):
    B = 1 << 20
    a = rand_limbs(G, B, cuda, seed=11 + G)
    lanes = torch.cat([torch.arange(512), torch.randint(0, B, (512,)),
                       torch.arange(B - 512, B)]).to(cuda)
    got = mont.sqr(a).index_select(-1, lanes)
    torch.cuda.synchronize()
    assert torch.equal(got, mont.sqr_plain(a.index_select(-1, lanes)))


# plan widths: a single lane, narrow grids of one-lane tiles, a ragged last
# tile (1021 = 255 tiles of 4 lanes and one of 1), full tiles
PLAN_WIDTHS = [1, 7, 130, 1021, 1024]


def plan_operands(plan, B: int, device) -> torch.Tensor:
    """[n_in, 24, B] random canonical limbs; the first lanes hold every row
    p-1, every row 0, rows cycling 0, 1, p-1 and every row 1, as many as B
    has room for."""
    n = plan.n_in
    x = rand_limbs(n, max(B, 3), "cpu", seed=plan.n_slots + B)[..., :B]
    cols = [torch.tensor(params.to_limbs(v, 24)) for v in EDGES]
    for lane, pattern in enumerate(
            ([2] * n, [0] * n, [k % 3 for k in range(n)], [1] * n)[:B]):
        for k, e in enumerate(pattern):
            x[k, :, lane] = cols[e]
    return x.contiguous().to(device)


@pytest.mark.parametrize("B", PLAN_WIDTHS)
@pytest.mark.parametrize("make_plan", pe.MAIN_PATH_PLANS,
                         ids=lambda b: pe.compile_plan(b()).name)
def test_plan_kernel_matches_plain(cuda, make_plan, B):
    plan = pe.compile_plan(make_plan())
    ops = plan_operands(plan, B, cuda)
    got = pe.plan_exec(ops, plan)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), pe.plan_exec_plain(ops.cpu(), plan))


# the group-law plans also at 4096 lanes, the widest of the scalar
# multiplications and subgroup checks (port_cases.SMUL_ROWS); the adds at
# the MSM's widths (the segmented scan's top level: half the GLV lanes of
# msm_g1 at 2^16, the GLS lanes of msm_g2 at 2^12) and at msm_g1_large's
# chunk widths 2^21 and 2^22 (held on sampled lanes)
GROUP_LAW_CASES = [
    pytest.param(make_plan, B, id=f"{make_plan.__name__}-{B}")
    for B in PLAN_WIDTHS + [4096] for make_plan in pe.GROUP_LAW_PLANS] + [
    pytest.param(make_plan, B, id=f"{make_plan.__name__}-{B}")
    for make_plan, B in ((pe.g1_add_plan, 1 << 16), (pe.g2_add_plan, 1 << 13),
                         (pe.g1_add_plan, 1 << 21), (pe.g1_add_plan, 1 << 22))]


@pytest.mark.parametrize("make_plan,B", GROUP_LAW_CASES)
def test_group_law_plan_kernel_matches_plain(cuda, make_plan, B):
    plan = pe.compile_plan(make_plan())
    ops = plan_operands(plan, B, cuda)
    got = pe.plan_exec(ops, plan)
    lanes = held_lanes(B, cuda)
    assert torch.equal(got.index_select(-1, lanes), pe.plan_exec_plain(
        ops.index_select(-1, lanes), plan))


def test_plan_kernel_reads_phase_before_writing(cuda):
    """A hand-made table whose one phase writes the slots it reads,
    (s0, s1) <- (s0 + s1, s0 - s1): the kernel's barrier gives the
    read-before-write values, as the plain version does."""
    instr = np.zeros((2, pe.INSTR_WIDTH), np.int32)
    instr[0, [0, 1, 3, 4]] = pe.OP_CODES["add"], 0, 0, 1
    instr[1, [0, 1, 3, 4]] = pe.OP_CODES["sub"], 1, 0, 1
    plan = pe.CompiledPlan(
        name="swap", n_in=2, n_slots=2, instr=instr,
        groups=((0, 1), (1, 2)), phases=((0, 2),),
        loads=np.array([[0, 0], [1, 1]], np.int32),
        out_slots=np.array([0, 1], np.int32))
    ops = rand_limbs(2, 300, cuda, seed=3)
    got = pe.plan_exec(ops, plan)
    torch.cuda.synchronize()
    a, b = ops.cpu()
    assert torch.equal(got.cpu(), torch.stack([limbs.add(limbs.FP, a, b),
                                               limbs.sub(limbs.FP, a, b)]))


# (G, T, B): uneven groups at 333 lanes, and the paths' widths: the line
# scaling's shape (G = 4, T = 1 over 68 x 1024 lanes), a fold of Fp2
# products (G = 8, T = 2) and groups up to T = 6 at the MSM's 2^16
FOLD_CASES = [pytest.param(G, T, 333, id=f"{G}-{T}")
              for G, T in ((4, 1), (8, 2), (5, 6), (64, 8))] + [
    pytest.param(G, T, B, id=f"{G}-{T}-{B}")
    for G, T, B in ((4, 1, 68 * 1024), (8, 2, 1 << 16), (4, 6, 1 << 16))]


@pytest.mark.parametrize("G,T,B", FOLD_CASES)
def test_fold_kernel_matches_plain(cuda, G, T, B):
    """Uneven groups over a stack whose row 0 is zeros; the last row is
    p-1 in every lane and fills group 0."""
    K = 2 * T + 3
    ops = rand_limbs(K, B, cuda, seed=G + T)
    ops[0] = 0
    ops[K - 1] = torch.tensor(params.to_limbs(P - 1, 24),
                              device=cuda).unsqueeze(-1)
    rng = np.random.default_rng(G * T)
    ia = rng.integers(1, K, (G, T)).astype(np.int32)
    ib = rng.integers(1, K, (G, T)).astype(np.int32)
    ia[0], ib[0] = K - 1, K - 1
    for g in range(1, G):
        ia[g, rng.integers(1, T + 1):] = 0
    LAUNCHES.reset()
    got = mont.fold_planned(ops, ia, ib)
    torch.cuda.synchronize()
    assert LAUNCHES.fold_planned == 1
    assert torch.equal(got, mont.fold_planned_plain(ops, ia, ib))


# the row kernel's launch shapes: (lane tile, group slots, threads per
# group), each at B = 1, 33 (ragged tiles) and 1024: terms split over 6, 3
# and 1 threads, groups in two rounds of a block, and a 32-lane tile
ROW_SHAPES = {"split 6": (4, 6, 6), "split 3, rounds": (8, 4, 3),
              "split 1": (4, 6, 1), "tile 32": (32, 8, 1),
              "chosen": None}


@pytest.mark.parametrize("B", [1, 33, 1024])
@pytest.mark.parametrize("shape", list(ROW_SHAPES))
def test_sop_rows_launch_shapes_match_plain(cuda, shape, B):
    """Ten uneven groups of up to six terms; group 0 multiplies the p-1 row
    by itself six times (the fold's all-(p-1) carry case), group 1 sums
    eight products (T = 8) of rows whose lane 2 is p-1."""
    K = 14
    rows = list(rand_limbs(K, max(B, 3), cuda, seed=B)[..., :B])
    rows[K - 1] = torch.tensor(params.to_limbs(P - 1, 24), device=cuda,
                               dtype=torch.int32).unsqueeze(-1).expand(24, B)
    rng = np.random.default_rng(B)
    G, T = 10, 8
    ia = rng.integers(0, K - 1, (G, T))
    ib = rng.integers(0, K - 1, (G, T))
    counts = np.concatenate([[6, 8], rng.integers(1, 7, G - 2)])
    ia[0], ib[0] = K - 1, K - 1
    shp = ROW_SHAPES[shape]
    if shp is not None:
        shp = (shp[0], min(shp[1], G), min(shp[2], T))
    got = mont.sop_rows(limbs.FP, rows, ia, ib, counts, (B,), shape=shp)
    torch.cuda.synchronize()
    want = mont.sop_rows_plain(limbs.FP, [r.cpu() for r in rows], ia, ib,
                               counts, (B,))
    assert torch.equal(got.cpu(), want)


def row_layout_call(layout, device):
    """(spec, rows, ia, ib, counts, batch, rows copied) of an operand
    layout the paths hand to the row kernel."""
    fp_rows = rand_limbs(8, 64, "cpu", seed=len(layout)).to(device)
    if layout == "line scaling":
        coeffs = rand_limbs(4 * 3 * 2, 64, "cpu", seed=2).reshape(
            4, 3, 2, 24, 64).to(device)
        comp = [coeffs[:, i, j].movedim(1, 0)
                for i, j in ((0, 0), (0, 1), (2, 0), (2, 1))]
        yp, xp = fp_rows[0], fp_rows[1]
        rows = comp + [yp.unsqueeze(1).expand(24, 4, 64),
                       xp.unsqueeze(1).expand(24, 4, 64)]
        return (limbs.FP, rows, [[0], [1], [2], [3]], [[4], [4], [5], [5]],
                [1] * 4, (4, 64), 0)
    if layout == "0::2":
        t = rand_limbs(1, 130, "cpu", seed=4)[0].to(device)
        return (limbs.FP, [t[:, 0::2], t[:, 1::2]], [[0], [1]], [[1], [1]],
                [1, 1], (65,), 0)
    if layout == "[24, n, 1]":
        tot = fp_rows[:3, :, :1].permute(1, 0, 2)  # [24, 3, 1]
        oth = rand_limbs(3, 64, "cpu", seed=5).permute(1, 0, 2).to(device)
        return (limbs.FP, [oth, tot], [[0, 1]], [[1, 0]], [2], (3, 64), 0)
    if layout == "[24, 1] constant":
        return (limbs.FP, [fp_rows[2], fp_rows[3, :, :1]], [[0], [1]],
                [[1], [1]], [1, 1], (64,), 0)
    if layout == "non-affine":
        x = rand_limbs(2, 3 * 64, "cpu", seed=6).reshape(2, 24, 3, 64)
        twisted = x.permute(1, 2, 0, 3).to(device)  # [24, 3, 2, 64]
        return (limbs.FP, [twisted, fp_rows[4]], [[0, 1]], [[1, 0]], [2],
                (3, 2, 64), 1)
    assert layout == "fr [16, 1] constant"
    a = rand_fr(2, 64, device, seed=7)
    return (limbs.FR, [a[0], a[1, :, :1], a[1]], [[0, 1], [1, 1]],
            [[1, 2], [0, 1]], [2, 1], (64,), 0)


def smul_row(group: str, name: str, n: int, dev):
    """(function, inputs) of a row of port_cases.SMUL_ROWS at n lanes:
    scalar_mul's `entry.smul_inputs`; the subgroup rows' the scalar
    multiplication's output with the lanes i % 64 == 17 outside the
    subgroup; batch_normalize's projective [i+1]G."""
    mod = {"g1": g1, "g2": g2, "gt": gt}[group]
    log_n = (n - 1).bit_length()
    if name == "scalar_mul":
        args = entry.smul_inputs(log_n, group, seed=pc.SEED, device=dev)
    elif name == "batch_normalize":
        args = (pc.normalize_inputs(group, n, dev),)
    else:
        pts = mod.scalar_mul(*entry.smul_inputs(log_n, group, seed=pc.SEED,
                                                device=dev))
        args = (pc.with_bad_lanes(group, pts, dev),)
    return getattr(mod, name), args


# the calls of whole paths as they make them, in their own layouts: one
# pairing at batch 1024 (its 31 folds and its norm), one msm_g1 at 2^16
# (its products), one ntt at 2^20 (its twiddle doublings), one call of each
# scalar multiplication row at its width
PATHS = {
    "pairing 1024": lambda dev: (pr.pairing,
                                 entry.tiny_pairing_inputs(1024, dev)),
    "msm_g1 2^16": lambda dev: (msm.msm_g1,
                                entry.msm_inputs(16, "g1", device=dev)),
    "ntt 2^20": lambda dev: (ntt.ntt, (entry.ntt_inputs(20, device=dev),)),
    **{f"{g} {name} {n}": (lambda dev, g=g, name=name, n=n: smul_row(
        g, name, n, dev)) for g, name, n in pc.SMUL_ROWS}}


@pytest.mark.parametrize("layout", [
    "line scaling", "0::2", "[24, n, 1]", "[24, 1] constant", "non-affine",
    "fr [16, 1] constant"] + list(PATHS))
def test_sop_rows_reads_layouts_in_place(cuda, monkeypatch, layout):
    """Views, broadcasts and constants read where they lie (no copied row),
    a non-affine operand copied once; the kernel equals its plain version
    on each, and on every call a path makes (run eagerly: no graph kept),
    as it makes it (g1.clear_cofactor makes none: plans only)."""
    if layout in PATHS:
        fn, args = PATHS[layout](cuda)
        real, held = mont.sop_rows, []

        def spy(spec, rows, ia, ib, counts, batch, shape=None):
            got = real(spec, rows, ia, ib, counts, batch, shape)
            held.append(torch.equal(got, mont.sop_rows_plain(
                spec, rows, ia, ib, counts, batch)))
            return got

        monkeypatch.setattr(graphs, "_graphs", collections.OrderedDict())
        monkeypatch.setattr(mont, "sop_rows", spy)
        LAUNCHES.reset()
        fn(*args)
        torch.cuda.synchronize()
        assert LAUNCHES.copied_rows == 0
        assert len(held) == LAUNCHES.sop + LAUNCHES.fold_planned + \
            LAUNCHES.sop_fr
        assert all(held), held
        return
    *call, copies = row_layout_call(layout, cuda)
    LAUNCHES.reset()
    got = mont.sop_rows(*call)
    torch.cuda.synchronize()
    assert LAUNCHES.copied_rows == copies
    spec, rows, *rest = call
    want = mont.sop_rows_plain(spec, [r.cpu() for r in rows], *rest)
    assert torch.equal(got.cpu(), want)


def rand_fr(n: int, lanes: int, device, seed: int) -> torch.Tensor:
    """[n, 16, lanes] random canonical Fr limbs; lanes 0..3 of every row
    hold 0, 1, q-1 and q-2."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 1 << 16, (n, 16, lanes), generator=gen,
                      dtype=torch.int32)
    x[:, 15] &= 0x3FFF
    for lane, v in enumerate((0, 1, Q - 1, Q - 2)):
        x[:, :, lane] = torch.tensor(params.to_limbs(v, 16))
    return x.to(device)


# (T, B): 333 lanes, 2^16, and the NTT's 1/N scaling at 2^20
@pytest.mark.parametrize("T,B", [
    pytest.param(1, 333, id="1"), pytest.param(2, 333, id="2"),
    pytest.param(1, 1 << 16, id="1-65536"),
    pytest.param(2, 1 << 16, id="2-65536"),
    pytest.param(1, 1 << 20, id="1-1048576")])
def test_sop_fr_kernel_matches_plain(cuda, T, B):
    """Lanes 0..3 of a every operand 0, 1, q-1, q-2 (b's reversed)."""
    a = rand_fr(T, B, cuda, seed=20 + T)
    b = rand_fr(T, B, cuda, seed=30 + T).flip(-1).contiguous()
    got = mont.sop_fr(a, b)
    assert torch.equal(got, mont.sop_fr_plain(a, b))


# 300 lanes, 2^16, and one stage of the NTT at 2^20 (2^19 butterflies)
@pytest.mark.parametrize("B", [300, 1 << 16, 1 << 19])
def test_butterfly_kernel_matches_plain(cuda, B):
    """Random lanes plus the rows of tests/test_device_fields.py that take
    lo's -q and hi's +q corrections."""
    a, b, w = rand_fr(3, B, cuda, seed=41)
    edge = {"a": [0, 1, Q - 1, Q - 2, 0, Q - 1],
            "b": [Q - 1, 0, Q - 1, 1, 0, 1],
            "w": [Q - 1, 5, Q - 1, 1, 7, Q - 1]}
    for x, key in ((a, "a"), (b, "b"), (w, "w")):
        x[:, 10:16] = fr.from_ints(edge[key], device=cuda)
    got = mont.butterfly(a, b, w)
    assert torch.equal(got, mont.butterfly_plain(a, b, w))


# 0 (every digit zero: one), 1 (a itself), 2, 16 and 2^1024 - 1 (the
# 256-digit cap) beside the paths' own exponents: the inversions' p - 2 and
# q - 2, the square roots' (p+1)/4 and Fr's (t-1)/2, the Legendre symbol's
# (p-1)/2
T_FR = (Q - 1) >> params.FR_S
POW_EXPONENTS = {"p-2": P - 2, "(p+1)/4": (P + 1) // 4,
                 "(p-1)/2": (P - 1) // 2,
                 "q-2": Q - 2, "(t-1)/2": (T_FR - 1) // 2, "0": 0, "1": 1,
                 "2": 2, "16": 16, "2^1024-1": (1 << 1024) - 1}


def pow_operand(spec, B: int, device, seed: int) -> torch.Tensor:
    """[L, B] random canonical limbs; lanes 1..6 hold 0, 1, 2, m-1, m-2
    and R mod m, as many as B has room for (lane 0 stays random)."""
    L, m = spec.n_limbs, spec.modulus
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 1 << 16, (L, B), generator=gen, dtype=torch.int32)
    x[L - 1] %= spec.p_limbs[L - 1]
    edges = (0, 1, 2, m - 1, m - 2, (1 << (16 * L)) % m)
    for lane, v in enumerate(edges[:max(B - 1, 0)]):
        x[:, lane + 1] = torch.tensor(params.to_limbs(v, L))
    return x.to(device)


@pytest.mark.parametrize("name", list(POW_EXPONENTS))
@pytest.mark.parametrize("B", [1, 33, 1021, 1024])
@pytest.mark.parametrize("wrapper", ["pow_fixed", "pow_fixed_fr"])
def test_pow_kernel_matches_plain(cuda, wrapper, B, name):
    """One launch, B = 33 and 1021 ragged blocks; over Fr, p-2, (p+1)/4
    and (p-1)/2 are wider than q."""
    spec = limbs.FP if wrapper == "pow_fixed" else limbs.FR
    a = pow_operand(spec, B, cuda, seed=B)
    e = POW_EXPONENTS[name]
    LAUNCHES.reset()
    got = getattr(mont, wrapper)(a, e)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot()[wrapper] == 1
    assert torch.equal(got, mont.pow_fixed_plain(spec, a, e))


@pytest.mark.parametrize("B", [1 << 13, 1 << 16])
@pytest.mark.parametrize("wrapper, name", [
    ("pow_fixed", "p-2"), ("pow_fixed", "(p+1)/4"), ("pow_fixed_fr", "q-2"),
    ("pow_fixed_fr", "(t-1)/2"), ("pow_fixed", "(p-1)/2"), ("pow_fixed", "1"),
    ("pow_fixed", "2"), ("pow_fixed", "16")])
def test_pow_kernel_full_card_matches_plain_on_sampled_lanes(cuda, wrapper,
                                                             name, B):
    """8192 lanes (two threads a lane) and 2^16 (one) in one launch, held
    on the first, the last and 1024 random lanes (the plain version at
    that width would take minutes)."""
    spec = limbs.FP if wrapper == "pow_fixed" else limbs.FR
    a = pow_operand(spec, B, cuda, seed=16)
    e = POW_EXPONENTS[name]
    got = getattr(mont, wrapper)(a, e)
    torch.cuda.synchronize()
    pick = torch.unique(torch.cat([
        torch.arange(64), torch.arange(B - 64, B),
        torch.randint(0, B, (1024,), generator=torch.Generator().manual_seed(
            16))])).to(cuda)
    assert torch.equal(got[:, pick], mont.pow_fixed_plain(spec, a[:, pick], e))


# the Fp2 square root's two exponents beside 0 (one), 1 (a) and 2
FP2_POW_EXPONENTS = {"(p-3)/4": (P - 3) // 4, "(p-1)/2": (P - 1) // 2,
                     "0": 0, "1": 1, "2": 2}
FP2_EDGES = ((0, 0), (1, 0), (0, 1), (P - 1, P - 1), (0, P - 1), (P - 1, 0),
             (P - 1, 1), (1, P - 1), ((1 << 384) % P, 0))


def fp2_pow_operand(B: int, device, seed: int):
    """Random canonical (a0, a1) [24, B]; lanes 0..8 hold FP2_EDGES, as
    many as B has room for."""
    a0 = pow_operand(limbs.FP, B, "cpu", seed)
    a1 = pow_operand(limbs.FP, B, "cpu", seed + 1)
    for lane, (x, y) in enumerate(FP2_EDGES[:B]):
        a0[:, lane] = torch.tensor(params.to_limbs(x, 24))
        a1[:, lane] = torch.tensor(params.to_limbs(y, 24))
    return a0.to(device), a1.to(device)


@pytest.mark.parametrize("name", list(FP2_POW_EXPONENTS))
@pytest.mark.parametrize("B", [1, 33, 256, 512, 1021, 1024])
def test_fp2_pow_kernel_matches_plain(cuda, B, name):
    """One launch; B = 33 one live lane in a second block, 1021 a ragged
    block."""
    a0, a1 = fp2_pow_operand(B, cuda, seed=B)
    e = FP2_POW_EXPONENTS[name]
    LAUNCHES.reset()
    got = mont.fp2_pow_fixed(a0, a1, e)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot()["fp2_pow_fixed"] == 1
    want = mont.fp2_pow_plain(a0, a1, e)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", ["(p-3)/4", "(p-1)/2", "0", "1", "2"])
def test_fp2_pow_kernel_full_card_matches_plain_on_sampled_lanes(cuda, name):
    """2^16 lanes in one launch, held on the first, the last and 1024
    random lanes (the plain version at that width would take minutes)."""
    B = 1 << 16
    a0, a1 = fp2_pow_operand(B, cuda, seed=16)
    e = FP2_POW_EXPONENTS[name]
    got = torch.stack(mont.fp2_pow_fixed(a0, a1, e))
    torch.cuda.synchronize()
    pick = torch.unique(torch.cat([
        torch.arange(64), torch.arange(B - 64, B),
        torch.randint(0, B, (1024,), generator=torch.Generator().manual_seed(
            16))])).to(cuda)
    want = torch.stack(mont.fp2_pow_plain(a0[:, pick], a1[:, pick], e))
    assert torch.equal(got[..., pick], want)


def horner(cs, z: int) -> int:
    """sum_i cs[i] z^i mod q."""
    acc = 0
    for c in reversed(cs):
        acc = (acc * z + c) % Q
    return acc


@pytest.mark.parametrize("log_n", [12, 20])
def test_ntt_on_card_matches_cpu(cuda, log_n):
    """Launches of one ntt and one intt = `port_cases.expected_ntt_launches`;
    intt(ntt(x)) = x.  At 2^12 the card = the CPU path; at 2^20 eight
    outputs = the host's evaluation at omega^k (the transform is linear,
    so the stored Montgomery values evaluate directly), and poly_mul of two
    2^19-coefficient polynomials (two ntt, one product, one intt) gives
    c(r) R = a(r) b(r) at four points."""
    n = 1 << log_n
    x = entry.ntt_inputs(log_n, seed=5)
    LAUNCHES.reset()
    got = ntt.ntt(x)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == pc.expected_ntt_launches(n, False)
    LAUNCHES.reset()
    assert torch.equal(ntt.intt(got), x)
    assert LAUNCHES.snapshot() == pc.expected_ntt_launches(n, True)
    if log_n == 12:
        assert torch.equal(got.cpu(), ntt.ntt(x.cpu()))
        return
    rng = np.random.default_rng(log_n)
    ks = [0, n - 1] + [int(k) for k in rng.integers(1, n - 1, 6)]
    omega = pow(params.FR_ROOT_OF_UNITY, 1 << (params.FR_S - log_n), Q)
    cs = pc.limb_ints(x)
    assert pc.limb_ints(got[:, ks]) == [horner(cs, pow(omega, k, Q))
                                        for k in ks]
    a = entry.ntt_inputs(log_n - 1, seed=6)
    b = entry.ntt_inputs(log_n - 1, seed=7)
    LAUNCHES.reset()
    c = ntt.poly_mul(a, b)
    torch.cuda.synchronize()
    fwd = pc.expected_ntt_launches(n, False)
    inv = pc.expected_ntt_launches(n, True)
    assert LAUNCHES.butterfly == 2 * fwd["butterfly"] + inv["butterfly"]
    assert LAUNCHES.sop_fr == 2 * fwd["sop_fr"] + 1 + inv["sop_fr"]
    assert c.shape == (16, n)
    ai, bi, ci = (pc.limb_ints(t) for t in (a, b, c))
    for r in (int(v) for v in rng.integers(2, 1 << 62, 4)):
        assert horner(ci, r) * (1 << 256) % Q == \
            horner(ai, r) * horner(bi, r) % Q


def fp12_rows(f) -> torch.Tensor:
    return torch.stack([c for c6 in f for c2 in c6 for c in c2])


def pairing_launches() -> dict:
    got = LAUNCHES.snapshot()
    del got["plan_exec_by_plan"]
    return got


@pytest.mark.parametrize("case", ["batch 2", "vectors 1024",
                                  "multi-pairing"])
def test_pairing_on_card_matches_cpu(cuda, case):
    """batch 2: `entry.entry`'s e([i+1]G1, [2i+1]G2) = the CPU path.
    vectors 1024: [a]G1, [b]G2 from tests/vectors (a, b < 1000,
    `port_cases.pairing_inputs`): launches = `port_cases.expected_launches`
    (no copied row), lane e(G1, G2) = the RELIC value, identity lanes one,
    lanes of equal a b equal, four lanes = the CPU path.  multi-pairing:
    final_exponentiation(multi_miller_loop) over eight terms with a G1 and
    a G2 identity = the host oracle's."""
    if case == "multi-pairing":
        terms = pc.oracle_inputs()["terms"]
        p, q = pc.encode(
            [(0, 0, True) if a is None else (a[0], a[1], False)
             for a, _ in terms],
            [((0, 0), (0, 0), True) if b is None else (b[0], b[1], False)
             for _, b in terms], cuda)
        LAUNCHES.reset()
        f = pr.final_exponentiation(pr.multi_miller_loop(
            p, pr.prepare_g2(q)))
        want = pc.expected_oracle_launches("multi_pairing", len(terms))
        got = pairing_launches()
        assert {k: got[k] for k in want} == want
        assert pc.fp12_host(f) == pc.host_multi_pairing(terms)
        return
    if case == "vectors 1024":
        a_idx, b_idx, p, q = pc.pairing_inputs(cuda)
        LAUNCHES.reset()
        rows = fp12_rows(pr.pairing(p, q))
        want = pc.expected_launches()
        got = pairing_launches()
        assert {k: got[k] for k in want} == want
        relic = json.loads((VECTORS / "ref_constants.json").read_text())[
            "relic_pairing_fp12"]
        assert [int(limbs.to_ints(limbs.FP, rows[i, :, 0]))
                for i in range(12)] == [int(v, 16) for v in relic]
        one = fp12_rows(tw.fp12_one((1,), cuda))[..., 0]
        by_product = collections.defaultdict(list)
        for lane, (a, b) in enumerate(zip(a_idx, b_idx)):
            if a == 0 or b == 0:
                assert torch.equal(rows[..., lane], one), lane
            else:
                by_product[a * b].append(lane)
        groups = [lanes for lanes in by_product.values() if len(lanes) > 1]
        assert groups
        for lanes in groups:
            for lane in lanes[1:]:
                assert torch.equal(rows[..., lane], rows[..., lanes[0]])
        lanes = [0, 4, 512, 1023]
        ref = pr.pairing(*(scans.tree_map(lambda t: t.cpu(), pc.pick_lanes(
            x, lanes)) for x in (p, q)))
        assert torch.equal(fp12_rows(ref), rows[..., lanes].cpu())
        return
    fn, (p, q) = entry.entry(batch=2)
    assert p[0].device.type == "cuda"
    LAUNCHES.reset()
    out = fn(p, q)
    torch.cuda.synchronize()
    counts = LAUNCHES.snapshot()
    # fp12_inv's one Fp inversion is one pow_fixed launch, no sqr chain
    assert counts["pow_fixed"] == 1 and counts["sqr"] == 0
    assert min(counts["sop"], counts["plan_exec"]) > 0

    def to_cpu(x):
        return tuple(to_cpu(y) for y in x) if isinstance(x, tuple) \
            else x.cpu()

    ref = fn(to_cpu(p), to_cpu(q))
    for g6, r6 in zip(out, ref):
        for g2, r2 in zip(g6, r6):
            for g, r in zip(g2, r2):
                assert torch.equal(g.cpu(), r)


# (group, lg N, window, chunk sizes of msm_g1_large): 32 points at window 6
# and 2^10 at the library's window 12 (the card = the CPU path, the split
# = the plain digits); msm_g1 at 2^16 and msm_g2 at 2^12 (the library's
# widths); msm_g1_large at 2^20 (windows 13 and 12), at 2^22 (one chunk =
# one msm_g1 pipeline, and two) and at 2^24 (chunks of 2^21, 2^22, 2^23)
MSM_CASES = [pytest.param("g1", 5, 6, (21,), id="g1"),
             pytest.param("g2", 5, 6, None, id="g2")] + [
    pytest.param(g, log_n, c, chunks, id=f"{g}-{log_n}-{c}" + (
        f"-{'-'.join(map(str, chunks))}" if chunks and log_n > 21 else ""))
    for g, log_n, c, chunks in (
        ("g1", 10, 12, (21,)), ("g2", 10, 12, None), ("g1", 16, 12, (21,)),
        ("g2", 12, 12, None), ("g1", 20, 13, (21,)), ("g1", 20, 12, (21,)),
        ("g1", 22, 12, (22, 21)), ("g1", 24, 13, (21, 22, 23)))]


@pytest.mark.parametrize("group,log_n,c,chunks", MSM_CASES)
def test_msm_on_card_matches_cpu(cuda, group, log_n, c, chunks):
    """`entry.msm_entry` (msm_g1_large for G1 at each chunk size, msm_g2):
    the inputs hold the identity exactly at i % 64 == 5 and zero scalars at
    i % 64 == 9; launches = `port_cases.expected_msm_large_launches` /
    `expected_msm_launches`; the affine point = the host's
    [sum_i k_i (i+1)]G (`port_cases.msm_host_sum`); up to 2^10 points the
    card = the CPU path limb for limb and the split = the plain digits."""
    fn, (pts, sc) = entry.msm_entry(log_n, group, seed=3)
    n = 1 << log_n
    mod = {"g1": g1, "g2": g2}[group]
    lane = torch.arange(n, device=cuda) % entry.MSM_LANE_CYCLE
    assert torch.equal(mod.is_identity(pts), lane == entry.MSM_IDENTITY_LANE)
    assert not sc[:, lane == entry.MSM_ZERO_LANE].any()
    want = pc.msm_host(group, pts, sc)
    for chunk in chunks or (None,):
        LAUNCHES.reset()
        if group == "g1":
            got = fn(pts, sc, c, chunk_log2=chunk)
            schedule = pc.expected_msm_large_launches(n, c, chunk)
        else:
            got = fn(pts, sc, c)
            schedule = pc.expected_msm_launches(group, n, c)
        torch.cuda.synchronize()
        assert LAUNCHES.snapshot() == schedule, chunk
        assert pc.affine_ints(group, got) == want, chunk
    if log_n <= 10:
        ref = fn(scans.tree_map(lambda t: t.cpu(), pts), sc.cpu(), c)
        assert all(torch.equal(a.cpu(), b) for a, b in
                   zip(scans.tree_leaves(got), scans.tree_leaves(ref)))
        assert bool(mod.eq(got, fn(pts, sc, c, False)))


def _bad_point(group, n, device):
    """n lanes of the host's point outside G1 / G2, projective."""
    mod = {"g1": g1, "g2": g2}[group]
    const = {"g1": lambda v: limbs.const(limbs.FP, v, (n,), device),
             "g2": lambda v: tw.fp2_const(v, (n,), device)}[group]
    x, y = getattr(hm, f"{group}_point_outside_subgroup")()
    return mod.from_affine((const(x), const(y), torch.zeros(
        n, dtype=torch.bool, device=device)))


# every public function of the scalar multiplication, subgroup and Gt slice
SMUL_FUNCTIONS = [(g, name) for g in ("g1", "g2") for name in (
    "scalar_mul", "scalar_mul_generic", "mul_by_x", "is_torsion_free",
    "clear_cofactor")] + [("g2", "psi2"), ("gt", "scalar_mul"),
                          ("gt", "scalar_mul_generic"), ("gt", "fp12_pow")]


def hold_smul_row(group: str, name: str, n: int, dev) -> None:
    """A row of `smul_row` at its width: launches = its schedule
    (`port_cases.expected_smul_launches`; psi's `expected_oracle_launches`)
    and the row's checks against the host oracle: scalar_mul = the
    generic ladder on every lane and 8 lanes (an identity point, a zero
    scalar) = the host's [k (i+1)]G or e(G1, G2)^k; is_torsion_free false
    exactly at the lanes outside the subgroup; clear_cofactor torsion-free
    everywhere and the host's [h_eff]P there; batch_normalize 6 lanes =
    [i+1]G; psi every lane = the host's; then 16 lanes (two outside the
    subgroup) = the CPU path limb for limb."""
    fn, args = smul_row(group, name, n, dev)
    mod = {"g1": g1, "g2": g2, "gt": gt}[group]
    LAUNCHES.reset()
    out = fn(*args)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == (
        pc.expected_oracle_launches("psi", n) if name == "psi" else
        pc.expected_smul_launches(group, name, n))
    gen = {"g1": params.G1_GEN, "g2": params.G2_GEN}.get(group)
    mul = {"g1": hm.g1_mul, "g2": hm.g2_mul}.get(group)
    cycle = entry.MSM_LANE_CYCLE
    if name == "scalar_mul":
        lanes = [0, 1, entry.MSM_IDENTITY_LANE, entry.MSM_ZERO_LANE,
                 cycle - 1, n // 2 + 3, n - 2, n - 1]
        r_inv = pow(1 << 256, -1, Q)
        ks = [m * r_inv % Q for m in pc.limb_ints(args[1])]
        assert bool(mod.eq(out, mod.scalar_mul_generic(*args)).all())
        if group == "gt":
            assert pc.gt_lanes(out, lanes) == [
                hm.fp12_pow(hm.gt_generator(), ks[i]) for i in lanes]
        else:
            inf = mod.is_identity(args[0]).cpu().tolist()
            assert pc.affine_lanes(group, out, lanes) == [
                None if inf[i] else mul(gen, ks[i] * (i + 1) % Q)
                for i in lanes]
    elif name == "is_torsion_free":
        assert out.cpu().tolist() == [i % 64 != pc.BAD_LANE
                                      for i in range(n)]
    elif name == "clear_cofactor":
        assert bool(mod.is_torsion_free(out).all())
        lanes = [pc.BAD_LANE, 64 + pc.BAD_LANE, 0, n - 1]
        clear = {"g1": hm.g1_clear_cofactor, "g2": hm.g2_clear_cofactor}
        assert pc.affine_lanes(group, out, lanes) == [
            clear[group](pt) for pt in pc.affine_lanes(group, args[0],
                                                       lanes)]
    elif name == "batch_normalize":
        lanes = [0, 1, entry.MSM_IDENTITY_LANE, cycle - 1, 5000, n - 1]
        assert pc.affine_to_host(group, pc.pick_lanes(out, lanes)) == [
            None if i % cycle == entry.MSM_IDENTITY_LANE else mul(gen, i + 1)
            for i in lanes]
    else:
        lanes = list(range(n))
        assert pc.affine_lanes(group, out, lanes) == [
            hm.g2_psi(pt) for pt in pc.affine_lanes(group, args[0], lanes)]
    lanes = list(range(12)) + [pc.BAD_LANE, 64 + pc.BAD_LANE, n - 2, n - 1]
    sub = tuple(pc.pick_lanes(a, lanes) for a in args)
    assert pc.same_tree(fn(*sub), fn(*pc.to_cpu(sub)))


# the functions at 16 lanes, then the rows of port_cases.SMUL_ROWS and psi
# at their widths
SMUL_CASES = [pytest.param(g, name, 16, id=f"{g}-{name}")
              for g, name in SMUL_FUNCTIONS] + [
    pytest.param(g, name, n, id=f"{g}-{name}-{n}")
    for g, name, n in pc.SMUL_ROWS + (("g2", "psi", 256),)]


@pytest.mark.parametrize("group,name,n", SMUL_CASES)
def test_smul_on_card_matches_cpu(cuda, group, name, n):
    """16 lanes (`entry.smul_inputs`: an identity point, a zero scalar; for
    the subgroup functions lane 3 a point outside the subgroup) on the card
    against the CPU path, limb for limb in projective coordinates; the rows
    at their widths as `hold_smul_row` holds them."""
    if n > 16:
        hold_smul_row(group, name, n, cuda)
        return
    bases, sc = entry.smul_inputs(4, group, seed=11)
    if group == "gt":
        fn = (lambda a: tw.fp12_pow(a, params.BLS_X)) if name == "fp12_pow" \
            else getattr(gt, name)
    else:
        fn = getattr({"g1": g1, "g2": g2}[group], name)
    if name in ("scalar_mul", "scalar_mul_generic"):
        args = (bases, sc)
    else:
        bad = _bad_point(group, 16, cuda) if group != "gt" else bases
        lane = torch.arange(16, device=cuda) == 3
        args = (scans.tree_map(lambda b, p: torch.where(lane, b, p), bad,
                               bases),)
    LAUNCHES.reset()
    got = fn(*args)
    torch.cuda.synchronize()
    assert LAUNCHES.plan_exec + LAUNCHES.fold_planned > 0
    assert LAUNCHES.copied_rows == 0
    ref = fn(*scans.tree_map(lambda t: t.cpu(), args))
    assert all(torch.equal(a.cpu(), b) for a, b in
               zip(scans.tree_leaves(got), scans.tree_leaves(ref)))
    if name == "is_torsion_free":
        assert got.cpu().tolist() == [i != 3 for i in range(16)]


CODEC_CASES = [pytest.param(g, f, "32", id=f"{g}-{f}")
               for g in ("g1", "g2") for f in pc.CODEC_FORMS] + [
    pytest.param(g, f, what, id=f"{g}-{f}-{what}")
    for what in ("1024", "walk", "rejects")
    for g in ("g1", "g2") for f in pc.CODEC_FORMS]


@pytest.mark.parametrize("group,form,what", CODEC_CASES)
def test_codec_on_card_matches_cpu(cuda, group, form, what):
    """`entry.codec_inputs` at 32 and 1024 lanes (an identity, lanes
    i % 64 == 17 outside the subgroup): launches of the decoder and the
    encoder = `port_cases.expected_codec_launches`, the mask false exactly
    there (all true with the check off), the bytes = hostmath's encodings
    of the points, 8 lanes (1024) = the host oracle's decoding, the card =
    the CPU path in limbs and masks (every lane at 32, 16 lanes at 1024),
    the encoder gives the bytes back.  walk: the 1000-point
    tests/vectors/*.dat walk decodes valid and re-encodes byte for byte.
    rejects: every flag-bit reject of `port_cases.reject_cases` is invalid,
    G and the identity valid."""
    mod = {"g1": g1, "g2": g2}[group]
    dec = getattr(mod, f"from_{form}_host")
    enc = getattr(mod, f"to_{form}_host")
    host_dec = getattr(hm, f"{group}_from_{form}")
    host_enc = getattr(hm, f"{group}_to_{form}")
    if what == "walk":
        data = np.frombuffer((VECTORS / f"{group}_{form}_valid_test_vectors"
                              ".dat").read_bytes(), np.uint8).reshape(1000, -1)
        aff, valid = dec(data, device=cuda)
        assert valid.all() and np.array_equal(enc(aff), data)
        return
    if what == "rejects":
        cases = pc.reject_cases(group, form)
        gen = {"g1": params.G1_GEN, "g2": params.G2_GEN}[group]
        data = np.frombuffer(b"".join([c for _, c in cases] + [
            host_enc(gen), host_enc(None)]), np.uint8).reshape(
            len(cases) + 2, -1)
        _, valid = dec(data, device=cuda)
        assert valid.tolist() == [False] * len(cases) + [True, True]
        return
    log_n = 5 if what == "32" else 10
    n = 1 << log_n
    fn, (data,) = entry.codec_entry(log_n, group, form)
    LAUNCHES.reset()
    aff, valid = fn(data)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == pc.expected_codec_launches(
        group, f"from_{form}_host", n)
    assert valid.tolist() == [i % 64 != entry.CODEC_BAD_LANE
                              for i in range(n)]
    assert np.array_equal(data, np.frombuffer(b"".join(
        host_enc(pt) for pt in pc.codec_host_points(group, n)),
        np.uint8).reshape(n, -1))
    lanes = list(range(n)) if n == 32 else list(range(12)) + [
        entry.CODEC_BAD_LANE, 64 + entry.CODEC_BAD_LANE, n - 2, n - 1]
    ref, ref_valid = dec(data[lanes], device="cpu")
    got, got_valid = dec(data[lanes], device=cuda)
    assert np.array_equal(got_valid, ref_valid)
    assert pc.same_tree(got, ref)
    if n > 32:
        off = {"check_subgroup" if form == "compressed" else "check": False}
        assert fn(data, **off)[1].all()
        lanes = [0, 1, entry.MSM_IDENTITY_LANE, entry.CODEC_BAD_LANE, 63,
                 n // 2, n - 2, n - 1]
        assert pc.affine_to_host(group, pc.pick_lanes(aff, lanes)) == [
            host_dec(bytes(data[i]), **off) for i in lanes]
    LAUNCHES.reset()
    out = enc(aff)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot() == pc.expected_codec_launches(
        group, f"to_{form}_host", n)
    assert np.array_equal(out, data)


@pytest.mark.parametrize("group,kind,n", [
    pytest.param(g, k, n, id=f"{g}-{k}" + ("" if n == 4 else f"-{n}"))
    for n in (4, 256) for g, k in pc.H2C_ROWS])
def test_h2c_on_card_matches_cpu(cuda, group, kind, n):
    """`entry.h2c_entry` (device expansion) on the card and on the CPU:
    equal projective limbs (every lane at 4, 16 lanes at 256); G2 maps take
    four Fp2 power launches.  At 256 lanes: launches =
    `port_cases.expected_h2c_launches`, every output torsion-free, the
    affine points = hostmath's hash to curve (G1 every lane, G2 16 lanes),
    hash_to_curve_g2 with the host expander = with the device's."""
    from bls12_381_torch.hash_to_curve import h2c

    fn, (msgs, dst) = entry.h2c_entry(n.bit_length() - 1, group, kind)
    LAUNCHES.reset()
    got = fn(msgs, dst)
    torch.cuda.synchronize()
    assert LAUNCHES.fp2_pow_fixed == (4 if group == "g2" else 0)
    assert LAUNCHES.copied_rows == 0
    if n > 4:
        assert LAUNCHES.snapshot() == pc.expected_h2c_launches(group, kind, n)
        mod = {"g1": g1, "g2": g2}[group]
        assert bool(mod.is_torsion_free(got).all())
        lanes = pc.oracle_inputs()["g2_lanes"] if group == "g2" \
            else list(range(n))
        host = getattr(hm, f"{kind}_to_curve_{group}")
        assert pc.affine_lanes(group, got, lanes) == [
            host(bytes(msgs[i]), dst) for i in lanes]
        if (group, kind) == ("g2", "hash"):
            assert pc.same_tree(h2c.hash_to_curve_g2(
                [bytes(m) for m in msgs], dst, device=cuda), got)
        msgs = msgs[:16]
        got = fn(msgs, dst)
    ref = getattr(h2c, f"{kind}_to_curve_{group}")(msgs, dst,
                                                   expand="device",
                                                   device="cpu")
    assert all(torch.equal(a.cpu(), b) for a, b in
               zip(scans.tree_leaves(got), scans.tree_leaves(ref)))


def counted(check: str, n: int, fn):
    """fn's value; its launches = `port_cases.expected_oracle_launches`."""
    LAUNCHES.reset()
    out = fn()
    torch.cuda.synchronize()
    want = pc.expected_oracle_launches(check, n)
    got = LAUNCHES.snapshot()
    assert {k: got[k] for k in want} == want, check
    return out


@pytest.mark.parametrize("check", ["fr_sqrt", "fr_inv", "fr_codecs",
                                   "native_fp_codec", "native_xmd"])
def test_fr_and_native_match_the_host_oracle(cuda, check):
    """On `port_cases.oracle_inputs` (0, 1, q - 1, 4 and the non-square 7
    first): `fr.sqrt` on 2^10 lanes (roots, and the mask false exactly
    where `hostmath.fr_sqrt` gives None), `fr.inv` on the non-zero lanes,
    the Fr byte codecs with their non-canonical rejects; the native host
    runtime (`utils/native.py`): its Fp codec at 2^16 rows against
    `fp.from_bytes_host` on the card (limbs on the canonical rows, the
    mask) and back to the bytes, its XMD at 256 lanes x 128 and 256 bytes
    (and a 300-byte DST) against hostmath's and the device XMD, and
    len_in_bytes 8161 refused.  Each device call's launches = its
    schedule."""
    inputs = pc.oracle_inputs()
    vals = inputs["fr_vals"]
    if check == "fr_sqrt":
        root, ok = counted(check, len(vals), lambda: fr.sqrt(
            fr.from_ints(vals, device=cuda)))
        want = [hm.fr_sqrt(v) for v in vals]
        assert ok.cpu().tolist() == [r is not None for r in want]
        assert [int(r) for r, o in zip(fr.to_ints(root), ok.tolist())
                if o] == [r for r in want if r is not None]
    elif check == "fr_inv":
        nonzero = [v for v in vals if v]
        inv = counted(check, len(nonzero), lambda: fr.inv(
            fr.from_ints(nonzero, device=cuda)))
        assert list(fr.to_ints(inv)) == [hm.fr_inv(v) for v in nonzero]
    elif check == "fr_codecs":
        rows = inputs["fr_rows"]
        data = np.frombuffer(b"".join(rows), np.uint8).reshape(-1, 32)
        m, valid = counted("fr_from_bytes", len(rows),
                           lambda: fr.from_bytes_host(data, device=cuda))
        host = [hm.fr_from_bytes(r) for r in rows]
        assert valid.tolist() == [v is not None for v in host]
        assert not valid[-3:].any()
        assert [int(g) for g, v in zip(fr.to_ints(m), valid) if v] == [
            v for v in host if v is not None]
        back = counted("fr_to_bytes", len(rows), lambda: fr.to_bytes_host(m))
        assert [bytes(r) for r, v in zip(back, valid) if v] == [
            hm.fr_to_bytes(v) for v in host if v is not None]
        wide = inputs["wide"]
        w = counted("fr_from_bytes_wide", len(wide),
                    lambda: fr.from_bytes_wide_host(np.frombuffer(
                        b"".join(wide), np.uint8).reshape(-1, 64),
                        device=cuda))
        assert list(fr.to_ints(w)) == [hm.fr_from_bytes_wide(r)
                                       for r in wide]
    elif check == "native_fp_codec":
        rows, vals = inputs["fp_rows"], inputs["fp_vals"]
        nat, nat_ok = native.fp_from_bytes(rows)
        dev, dev_ok = counted("fp_from_bytes", len(vals),
                              lambda: fp.from_bytes_host(rows, device=cuda))
        assert nat_ok.tolist() == dev_ok.tolist() == [v < P for v in vals]
        dev = dev.cpu().numpy()
        assert np.array_equal(nat[:, nat_ok].astype(np.int64),
                              dev[:, nat_ok].astype(np.int64))
        assert not nat[:, ~nat_ok].any()
        assert np.array_equal(native.fp_to_bytes(nat)[nat_ok], rows[nat_ok])
    else:
        msgs = entry.h2c_inputs(pc.H2C_LOG_N)
        for dst in (entry.H2C_DST, inputs["big_dst"]):
            for length in (128, 256):
                nat = native.expand_message_xmd_sha256(
                    [bytes(r) for r in msgs], dst, length)
                assert [bytes(r) for r in nat] == [
                    hm.expand_message_xmd(bytes(r), dst, length)
                    for r in msgs]
                assert np.array_equal(nat, sha256.expand_message_xmd_sha256(
                    msgs, dst, length, cuda).cpu().numpy())
        with pytest.raises(ValueError):
            native.expand_message_xmd_sha256([b""], entry.H2C_DST, 8161)


MSM_LOG_N = {"g1": 16, "g2": 12}
PEAK_LIMIT_BYTES = 1 << 30  # a sharded call's own peak on one rank


@pytest.mark.parametrize("world", [1, 4])
def test_sharded_paths_on_card(cuda, world):
    """The sharded paths (`parallel/`) at full width on cuda:0: one NCCL
    rank in this process, or four gloo ranks spawned on the one card
    (`port_cases.spawn_ranks`; NCCL refuses two ranks of one communicator
    on one device), each running `port_cases.parallel_job` (a warm-up call,
    then a counted one): pairing_sharded at batch 1024 on the vectors'
    points, element-wise and aggregated with and without the final
    exponentiation; msm_g1_sharded at 2^16 and msm_g2_sharded at 2^12,
    window 12; ntt_sharded at 2^20 and its inverse; msm_g1 and the NTTs
    also on the 2 x 2 mesh.  Every rank's values = the local paths' (whose
    final-exponentiated product = the host's e(G1, G2)^(sum a_i b_i), whose
    MSMs = the host's point, whose intt gives x back), launches =
    `port_cases.expected_parallel_launches`, own peak < 1 GB, shard_batch's
    lanes = `port_cases.expected_shards`; `entry.multichip_entry` on every
    rank = the local paths on its inputs."""
    import torch.distributed as dist

    from bls12_381_torch.kernels import build

    build.build_all()  # the spawned ranks load the libraries, not build
    a_idx, b_idx, p, q = pc.pairing_inputs(cuda)
    x = entry.ntt_inputs(20, seed=pc.SEED, device=cuda)
    inputs = {"pairing": (p, q), "ntt": {20: x}, "ntt_y": {20: ntt.ntt(x)},
              **{f"msm_{g}": entry.msm_inputs(log_n, g, seed=pc.SEED,
                                              device=cuda)
                 for g, log_n in MSM_LOG_N.items()}}
    want = {}
    for row, (call, post) in pc.parallel_local(
            inputs, pc.PARALLEL_WINDOW).items():
        raw = call()
        value = post(raw)
        want[row] = pc.digest(value)
        if row == "pairing_agg_fe":
            s = sum(a * b for a, b in zip(a_idx, b_idx)) % Q
            assert pc.fp12_host(value) == hm.fp12_pow(hm.gt_generator(), s)
        elif row.startswith("msm_"):
            assert pc.affine_ints(row[-2:], raw) == pc.msm_host(
                row[-2:], *inputs[row])
        elif row.startswith("intt_"):
            assert torch.equal(value, x)
    if world == pc.PARALLEL_RANKS:
        for row in list(want):
            if row == "msm_g1" or row.split("_")[0] in ("ntt", "intt"):
                want[f"{row}_2x{world // 2}"] = want[row]
    spec = {"device": str(cuda), "window": pc.PARALLEL_WINDOW, "reps": 1,
            "values": False}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "inputs.pt")
        torch.save(pc.to_cpu(inputs), path)
        if world == 1:
            dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                    rank=0, world_size=1)
            try:
                ranks = [pc.parallel_job(spec, path)]
            finally:
                dist.destroy_process_group()
        else:
            ranks = pc.spawn_ranks(world, "gloo", spec, path, tmp)
    for rank, res in enumerate(ranks):
        assert set(res) - set(pc.NOT_ROWS) == set(want), rank
        if world == pc.PARALLEL_RANKS:
            assert res["shards"] == pc.expected_shards(rank, world)
        for row in want:
            got = res[row]
            assert got["value"] == want[row], (rank, row)
            mesh_shape = (2, world // 2) if "_2x" in row else (world,)
            kind = pc.parallel_kind(row)
            n = (1 << int(row.split("_")[1]) if kind in ("ntt", "intt")
                 else 1 << MSM_LOG_N[kind[4:]] if kind.startswith("msm")
                 else pc.BATCH)
            schedule = pc.expected_parallel_launches(kind, n, mesh_shape)
            assert {k: got["launches"][k] for k in schedule} == schedule, (
                rank, row)
            assert got["peak_bytes"] < PEAK_LIMIT_BYTES, (rank, row)
        results, ins = res["entry"]
        k = sum(int(v) for v in fr.to_ints(ins["msm"][1])) % Q
        for key in ("msm", "msm_2d") if world % 2 == 0 else ("msm",):
            assert pc.affine_ints("g1", results[key]) == hm.g1_mul(
                params.G1_GEN, k)
        assert pc.same_tree(results["ntt"], ntt.ntt(ins["ntt"].to(cuda)))
        ep, eq = scans.tree_map(lambda t: t.to(cuda), ins["pairing"])
        assert pc.fp12_host(results["pairing"]) == pc.fp12_host(
            pr.multi_miller_loop(ep, pr.prepare_g2(eq)))


# --- the hash kernels (csrc/sha256.cu, csrc/keccak.cu) ----------------------

HASH_CASES = {
    "sha256 msg=0": (0, lambda x: sha256.sha256(x),
                     lambda x: sha256.sha256_plain(x),
                     lambda m: hashlib.sha256(m).digest(), "sha256"),
    "sha256 msg=119": (119, lambda x: sha256.sha256(x),
                       lambda x: sha256.sha256_plain(x),
                       lambda m: hashlib.sha256(m).digest(), "sha256"),
    "xmd msg=32 out=256": (
        32, lambda x: sha256.expand_message_xmd_sha256(x, b"BENCH-DST_", 256),
        lambda x: sha256.expand_message_xmd_sha256_plain(x, b"BENCH-DST_",
                                                         256),
        lambda m: hm.expand_message_xmd(m, b"BENCH-DST_", 256),
        "xmd_sha256"),
    "xmd msg=0 out=48 dst=300": (
        0, lambda x: sha256.expand_message_xmd_sha256(x, b"D" * 300, 48),
        lambda x: sha256.expand_message_xmd_sha256_plain(x, b"D" * 300, 48),
        lambda m: hm.expand_message_xmd(m, b"D" * 300, 48), "xmd_sha256"),
    "shake128 msg=168 out=169": (
        168, lambda x: keccak.shake128(x, 169),
        lambda x: keccak.shake_plain(x, 169, 168),
        lambda m: hashlib.shake_128(m).digest(169), "shake"),
    "shake256 msg=135 out=512": (
        135, lambda x: keccak.shake256(x, 512),
        lambda x: keccak.shake_plain(x, 512, 136),
        lambda m: hashlib.shake_256(m).digest(512), "shake"),
    "xof256 msg=32 out=256": (
        32, lambda x: keccak.expand_message_xof_shake(x, b"BENCH-DST_", 256,
                                                      bits=256),
        lambda x: keccak.expand_message_xof_shake_plain(x, b"BENCH-DST_",
                                                        256, bits=256),
        lambda m: hm.expand_message_xof(m, b"BENCH-DST_", 256,
                                        hash_name="shake_256"), "shake"),
}


def dst_of(length: int) -> bytes:
    """The DST of a case: the bench DST, the proof-of-possession suite's,
    else `length` bytes from a formula (over 255: reduced on the host)."""
    named = {len(pc.HASH_DST): pc.HASH_DST, len(pc.BLS_DST): pc.BLS_DST}
    return named.get(length, bytes((7 * i + length) % 256
                                   for i in range(length)))


def xmd_case(m: int, n: int, d: int):
    dst = dst_of(d)
    return (m, lambda x: sha256.expand_message_xmd_sha256(x, dst, n),
            lambda x: sha256.expand_message_xmd_sha256_plain(x, dst, n),
            lambda msg: hm.expand_message_xmd(msg, dst, n), "xmd_sha256")


def sha256_case(m: int):
    return (m, sha256.sha256, sha256.sha256_plain,
            lambda msg: hashlib.sha256(msg).digest(), "sha256")


def shake_case(rate: int, m: int, out: int):
    name = {168: "shake_128", 136: "shake_256"}[rate]
    return (m, lambda x: keccak.shake(x, out, rate),
            lambda x: keccak.shake_plain(x, out, rate),
            lambda msg: hashlib.new(name, msg).digest(out), "shake")


def xof_case(bits: int, d: int, n: int):
    dst, name = dst_of(d), f"shake_{bits}"
    return (32, lambda x: keccak.expand_message_xof_shake(x, dst, n, bits),
            lambda x: keccak.expand_message_xof_shake_plain(x, dst, n, bits),
            lambda msg: hm.expand_message_xof(msg, dst, n, hash_name=name),
            "shake")


# every case of port_cases' hash lists: the XMD's (`xmd_cases`), the
# digest at every XMD_MSG_LENS, SHAKE's (`shake_cases`) and the XOF at both
# levels with DSTs of 10 and 300 bytes to 128 and 256; label -> (case,
# also at 2^16 lanes)
LISTED_HASHES = {
    **{f"xmd msg={m} out={n} dst={d}": (xmd_case(m, n, d),
                                        m == 32 and n <= 256)
       for m, n, d in pc.xmd_cases()},
    **{f"sha256 msg={m}": (sha256_case(m), True)
       for m in pc.XMD_MSG_LENS},
    **{f"shake rate={r} msg={m} out={o}": (shake_case(r, m, o),
                                          (m, o) == (r + 1, 512))
       for r, m, o in pc.shake_cases()},
    **{f"xof{bits} dst={d} out={n}": (xof_case(bits, d, n),
                                      (d, n) == (len(pc.HASH_DST), 256))
       for bits in (128, 256) for d in (len(pc.HASH_DST), 300)
       for n in (128, 256)}}
for label, (case, _) in LISTED_HASHES.items():
    HASH_CASES.setdefault(label, case)
HASH_WIDTHS = [pytest.param(case, B, id=f"{case}-{B}")
               for B in (1, 33, 1024) for case in HASH_CASES] + [
    pytest.param(case, 1 << 16, id=f"{case}-{1 << 16}")
    for case, (_, wide) in LISTED_HASHES.items() if wide]


@pytest.mark.parametrize("case,B", HASH_WIDTHS)
def test_hash_kernel_matches_plain_and_hashlib(cuda, case, B):
    """One launch; kernel = plain version on the card = hashlib on every
    lane, byte for byte."""
    msg_len, kernel, plain, host, counter = HASH_CASES[case]
    m = np.random.default_rng(B + msg_len).integers(0, 256, (B, msg_len),
                                                    dtype=np.uint8)
    x = torch.from_numpy(m).to(cuda)
    LAUNCHES.reset()
    got = kernel(x)
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.snapshot().items() if v} == {
        counter: 1}
    assert torch.equal(got, plain(x))
    assert [bytes(r) for r in got.cpu().numpy()] == [host(bytes(r))
                                                     for r in m]


# (msg_len, out_len, dst_len): the load and store widths' edges, then
# every XMD case of a length that loads by 16 at an aligned start
UNALIGNED_CASES = [pytest.param(m, n, len(pc.HASH_DST), id=f"{m}-{n}")
                   for m, n in ((32, 256), (64, 36), (55, 33), (0, 48))] + [
    pytest.param(m, n, d, id=f"{m}-{n}-{d}") for m, n, d in pc.xmd_cases()
    if m % 4 == 0]


@pytest.mark.parametrize("msg_len,out_len,dst_len", UNALIGNED_CASES)
@pytest.mark.parametrize("off", [0, 4, 1])
def test_xmd_kernel_reads_unaligned_rows(cuda, off, msg_len, out_len,
                                         dst_len):
    """Message rows `off` bytes past a 256-byte boundary: the 16-byte,
    4-byte and byte load instances of xmd_sha256_kernel (as
    `sha256.io_width` picks them) and the 16-byte, 4-byte and byte
    stores; kernel = plain version = hashlib on every lane."""
    dst = dst_of(dst_len)
    B = 33
    m = np.random.default_rng(off + msg_len).integers(
        0, 256, (B, msg_len), dtype=np.uint8)
    x = torch.empty(B * msg_len + off, dtype=torch.uint8,
                    device=cuda)[off:].view(B, msg_len)
    x.copy_(torch.from_numpy(m))
    if msg_len:  # an empty row has no address of its own
        assert sha256.io_width(x.data_ptr(), msg_len) == next(
            w for w in (16, 4, 1) if off % w == 0 and msg_len % w == 0)
    LAUNCHES.reset()
    got = sha256.expand_message_xmd_sha256(x, dst, out_len)
    torch.cuda.synchronize()
    assert LAUNCHES.xmd_sha256 == 1
    assert torch.equal(got, sha256.expand_message_xmd_sha256_plain(
        x, dst, out_len))
    assert [bytes(r) for r in got.cpu().numpy()] == [
        hm.expand_message_xmd(bytes(r), dst, out_len) for r in m]


def test_hash_wrappers_take_no_strided_cuda_tensor(cuda):
    x = torch.zeros((4, 64), dtype=torch.uint8, device=cuda)[:, :32]
    with pytest.raises(ValueError, match="contiguous"):
        sha256.expand_message_xmd_sha256(x, b"BENCH-DST_", 64)
    with pytest.raises(ValueError, match="contiguous"):
        keccak.shake128(x, 64)


def test_h2c_on_card_never_runs_the_plain_expanders(cuda, monkeypatch):
    """The routing: with every plain hash version patched to raise,
    hash_to_curve_g2 with device expansion runs on the card (its XMD one
    kernel launch) and equals the CPU path."""
    from bls12_381_torch.hash_to_curve import h2c

    fn, (msgs, dst) = entry.h2c_entry(2, "g2", "hash")
    ref = h2c.hash_to_curve_g2(msgs, dst, expand="device", device="cpu")

    def refuse(*a, **k):
        raise AssertionError("a plain hash version ran on the card's path")

    for mod, name in ((sha256, "sha256_plain"), (sha256, "_digest"),
                      (sha256, "expand_message_xmd_sha256_plain"),
                      (keccak, "shake_plain"),
                      (keccak, "expand_message_xof_shake_plain")):
        monkeypatch.setattr(mod, name, refuse)
    LAUNCHES.reset()
    got = fn(msgs, dst)
    torch.cuda.synchronize()
    assert LAUNCHES.xmd_sha256 == 1
    assert all(torch.equal(a.cpu(), b) for a, b in
               zip(scans.tree_leaves(got), scans.tree_leaves(ref)))
