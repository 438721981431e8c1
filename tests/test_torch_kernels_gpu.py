"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Tolerance: none (integer arithmetic) -- kernel and plain version must agree
limb for limb.  Every test here needs a CUDA device: without one it skips
(the `gpu` marker; the decision is taken in a fixture, never at import).
On a machine with a card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py

(`--noconftest`: the suite's conftest imports JAX, which the port's
machine need not have.)
"""

import hashlib

import numpy as np
import pytest
import torch

from bls12_381_torch import entry, hostmath as hm, limbs, params
from bls12_381_torch.curves import g1, g2
from bls12_381_torch.fields import fr, tower as tw
from bls12_381_torch.pairing import gt
from bls12_381_torch.kernels import (LAUNCHES, keccak, mont,
                                     plan_exec as pe, sha256)
from bls12_381_torch.ops import ntt
from bls12_381_torch.utils import scans

pytestmark = pytest.mark.gpu
P, Q = params.P, params.Q
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


SQR_EDGES = ((1 << 384) % P, (1 << 768) % P)  # R and R^2 mod p


@pytest.mark.parametrize("B", [1, 33, 257, 1024, 1 << 16])
@pytest.mark.parametrize("G", [1, 3])
def test_sqr_kernel_matches_plain(cuda, G, B):
    """mont_sqr.cuh's kernel at chip_smoke.SQR_WIDTHS' narrower widths;
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
    p-1, every row 0, and rows cycling 0, 1, p-1, as many as B has room
    for."""
    n = plan.n_in
    x = rand_limbs(n, max(B, 3), "cpu", seed=plan.n_slots + B)[..., :B]
    cols = [torch.tensor(params.to_limbs(v, 24)) for v in EDGES]
    for lane, pattern in enumerate(
            ([2] * n, [0] * n, [k % 3 for k in range(n)])[:B]):
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
# multiplications and subgroup checks in chip_smoke.py
@pytest.mark.parametrize("B", PLAN_WIDTHS + [4096])
@pytest.mark.parametrize("make_plan", pe.GROUP_LAW_PLANS,
                         ids=lambda b: b.__name__)
def test_group_law_plan_kernel_matches_plain(cuda, make_plan, B):
    plan = pe.compile_plan(make_plan())
    ops = plan_operands(plan, B, cuda)
    got = pe.plan_exec(ops, plan)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), pe.plan_exec_plain(ops.cpu(), plan))


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


@pytest.mark.parametrize("G,T", [(4, 1), (8, 2), (5, 6), (64, 8)])
def test_fold_kernel_matches_plain(cuda, G, T):
    """Uneven groups over a stack whose row 0 is zeros; the last row is
    p-1 in every lane and fills group 0."""
    K = 2 * T + 3
    ops = rand_limbs(K, 333, cuda, seed=G + T)
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
    assert torch.equal(got.cpu(), mont.fold_planned_plain(ops.cpu(), ia, ib))


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


@pytest.mark.parametrize("layout", [
    "line scaling", "0::2", "[24, n, 1]", "[24, 1] constant", "non-affine",
    "fr [16, 1] constant"])
def test_sop_rows_reads_layouts_in_place(cuda, layout):
    """Views, broadcasts and constants read where they lie (no copied row),
    a non-affine operand copied once; the kernel equals its plain version
    on each."""
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


@pytest.mark.parametrize("T", [1, 2])
def test_sop_fr_kernel_matches_plain(cuda, T):
    a = rand_fr(T, 333, cuda, seed=20 + T)
    b = rand_fr(T, 333, cuda, seed=30 + T).flip(-1).contiguous()
    got = mont.sop_fr(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), mont.sop_fr_plain(a.cpu(), b.cpu()))


def test_butterfly_kernel_matches_plain(cuda):
    """Random lanes plus the rows of tests/test_device_fields.py that take
    lo's -q and hi's +q corrections."""
    a, b, w = rand_fr(3, 300, cuda, seed=41)
    edge = {"a": [0, 1, Q - 1, Q - 2, 0, Q - 1],
            "b": [Q - 1, 0, Q - 1, 1, 0, 1],
            "w": [Q - 1, 5, Q - 1, 1, 7, Q - 1]}
    for x, key in ((a, "a"), (b, "b"), (w, "w")):
        x[:, 10:16] = fr.from_ints(edge[key], device=cuda)
    got = mont.butterfly(a, b, w)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), mont.butterfly_plain(a.cpu(), b.cpu(),
                                                       w.cpu()))


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
    ("pow_fixed_fr", "(t-1)/2")])
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


@pytest.mark.parametrize("name", ["(p-3)/4", "(p-1)/2"])
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


def test_ntt_on_card_matches_cpu(cuda):
    log_n = 12
    x = entry.ntt_inputs(log_n, seed=5)
    LAUNCHES.reset()
    got = ntt.ntt(x)
    torch.cuda.synchronize()
    counts = LAUNCHES.snapshot()
    assert counts["butterfly"] == log_n and counts["sop_fr"] == log_n - 1
    assert torch.equal(got.cpu(), ntt.ntt(x.cpu()))
    assert torch.equal(ntt.intt(got).cpu(), x.cpu())


def test_pairing_on_card_matches_cpu(cuda):
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


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_on_card_matches_cpu(cuda, group):
    fn, (pts, sc) = entry.msm_entry(5, group, seed=3)
    LAUNCHES.reset()
    got = fn(pts, sc, 6)
    torch.cuda.synchronize()
    counts = LAUNCHES.snapshot()
    assert counts["plan_exec"] > 0 and counts["sop_fr"] == 1
    assert counts["pow_fixed"] == 1 and counts["sqr"] == 0
    # to_affine's x, y products; on G2 also fp2_batch_inv's two products
    # and the GLS split's three psi (two Fp2 products in one fold each)
    assert counts["fold_planned"] == {"g1": 1, "g2": 5}[group]
    ref = fn(scans.tree_map(lambda t: t.cpu(), pts), sc.cpu(), 6)
    assert all(torch.equal(a.cpu(), b) for a, b in
               zip(scans.tree_leaves(got), scans.tree_leaves(ref)))


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


@pytest.mark.parametrize("group,name", SMUL_FUNCTIONS)
def test_smul_on_card_matches_cpu(cuda, group, name):
    """16 lanes (`entry.smul_inputs`: an identity point, a zero scalar; for
    the subgroup functions lane 3 a point outside the subgroup) on the card
    against the CPU path, limb for limb in projective coordinates."""
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


@pytest.mark.parametrize("group,form", [(g, f) for g in ("g1", "g2")
                                        for f in ("compressed",
                                                  "uncompressed")])
def test_codec_on_card_matches_cpu(cuda, group, form):
    """`entry.codec_inputs` at 32 lanes (an identity, lane 17 outside the
    subgroup) decoded on the card and on the CPU: equal limbs and masks; a
    G2 decompression is two Fp2 power launches; the encoder gives the
    bytes back."""
    fn, (data,) = entry.codec_entry(5, group, form)
    LAUNCHES.reset()
    aff, valid = fn(data)
    torch.cuda.synchronize()
    assert LAUNCHES.fp2_pow_fixed == (2 if (group, form) == ("g2",
                                                             "compressed")
                                      else 0)
    mod = {"g1": g1, "g2": g2}[group]
    ref, ref_valid = getattr(mod, f"from_{form}_host")(data, device="cpu")
    assert np.array_equal(valid, ref_valid)
    assert valid.tolist() == [i != entry.CODEC_BAD_LANE for i in range(32)]
    assert all(torch.equal(a.cpu(), b) for a, b in
               zip(scans.tree_leaves(aff), scans.tree_leaves(ref)))
    assert np.array_equal(getattr(mod, f"to_{form}_host")(aff), data)


@pytest.mark.parametrize("group,kind", [("g1", "hash"), ("g2", "hash"),
                                        ("g1", "encode"), ("g2", "encode")])
def test_h2c_on_card_matches_cpu(cuda, group, kind):
    """Four lanes of `entry.h2c_entry` (device expansion) on the card and
    on the CPU: equal projective limbs; G2 maps take four Fp2 power
    launches."""
    fn, (msgs, dst) = entry.h2c_entry(2, group, kind)
    LAUNCHES.reset()
    got = fn(msgs, dst)
    torch.cuda.synchronize()
    assert LAUNCHES.fp2_pow_fixed == (4 if group == "g2" else 0)
    assert LAUNCHES.copied_rows == 0
    from bls12_381_torch.hash_to_curve import h2c

    ref = getattr(h2c, f"{kind}_to_curve_{group}")(msgs, dst,
                                                   expand="device",
                                                   device="cpu")
    assert all(torch.equal(a.cpu(), b) for a, b in
               zip(scans.tree_leaves(got), scans.tree_leaves(ref)))


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


@pytest.mark.parametrize("B", [1, 33, 1024])
@pytest.mark.parametrize("case", list(HASH_CASES))
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


@pytest.mark.parametrize("msg_len,out_len", [(32, 256), (64, 36),
                                             (55, 33), (0, 48)])
@pytest.mark.parametrize("off", [0, 4, 1])
def test_xmd_kernel_reads_unaligned_rows(cuda, off, msg_len, out_len):
    """Message rows `off` bytes past a 256-byte boundary: the 16-byte,
    4-byte and byte load instances of xmd_sha256_kernel (as
    `sha256.io_width` picks them) and the 16-byte, 4-byte and byte
    stores; kernel = plain version = hashlib on every lane."""
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
    got = sha256.expand_message_xmd_sha256(x, b"BENCH-DST_", out_len)
    torch.cuda.synchronize()
    assert LAUNCHES.xmd_sha256 == 1
    assert torch.equal(got, sha256.expand_message_xmd_sha256_plain(
        x, b"BENCH-DST_", out_len))
    assert [bytes(r) for r in got.cpu().numpy()] == [
        hm.expand_message_xmd(bytes(r), b"BENCH-DST_", out_len) for r in m]


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
