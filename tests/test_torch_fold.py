"""The port's folds (kernels/mont.py `sop_rows` and its plain version,
`fold_planned`, and the `limbs.sop_fold` route that takes them) against the
JAX package on the CPU: the Pallas kernel `fold_planned_pallas` in interpret
mode and the jnp `sop_fold`, with the operands in the layouts the paths
hand to the kernel (views read in place, broadcasts, constants, and the one
layout that is copied first).

Tolerance: none (integer arithmetic) -- every comparison is exact equality
of 16-bit limbs.  Inputs are seeded random canonical elements with edge
lanes 0, 1 and p-1; data crosses between the packages as numpy.
"""

import random

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax.numpy as jnp
from bls12_381_tpu import limbs as jlb
from bls12_381_tpu.fields import fp as jfp, fr as jfr
from bls12_381_tpu.kernels import pallas_mont

from bls12_381_torch import convert, limbs
from bls12_381_torch.kernels import LAUNCHES, mont
from bls12_381_torch.params import P, Q

torch.set_num_threads(1)
rng = random.Random(4242)
NB = 32
EDGES = [0, 1, P - 1]


def rvals(n, mod=P, edges=EDGES):
    return list(edges) + [rng.randrange(mod) for _ in range(n - len(edges))]


def both(vals, jfield=jfp):
    j = jfield.from_ints(vals)
    return j, convert.fp_to_torch(np.asarray(j), "cpu")


def tables(groups_idx):
    """[G, T] int32 index tables of groups given as lists of (ia, ib),
    short groups padded with row 0."""
    t = max(len(g) for g in groups_idx)
    ia = np.zeros((len(groups_idx), t), np.int32)
    ib = np.zeros((len(groups_idx), t), np.int32)
    for gi, g in enumerate(groups_idx):
        for ti, (a, b) in enumerate(g):
            ia[gi, ti], ib[gi, ti] = a, b
    return ia, ib


# the groups of tests/test_device_fields.py (uneven lengths, repeated
# operands) over rows 1..3, and a 6-term group whose every operand is p-1
TABLE_CASES = {
    "uneven": [[(1, 2), (2, 3), (1, 1)], [(3, 3)], [(1, 3), (2, 2)],
               [(2, 1), (3, 1), (3, 2)]],
    "t6_all_p_minus_1": [[(4, 4)] * 6, [(1, 2)], [(4, 1), (2, 4)],
                         [(3, 3), (4, 4), (1, 1)]],
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_plain_fold_matches_pallas_interpret(case):
    x, y, z = (np.asarray(jfp.from_ints(rvals(NB))) for _ in range(3))
    pm1 = np.asarray(jfp.from_ints([P - 1] * NB))
    stack = np.stack([np.zeros_like(x), x, y, z, pm1])
    # lane 3 of every row is p-1 (raw limbs: the largest canonical value)
    stack[1:, :, 3] = np.asarray(jfp.from_ints([P - 1], to_mont=False))[:, 0]
    ia, ib = tables(TABLE_CASES[case])
    want = pallas_mont.fold_planned_pallas(
        jnp.asarray(stack), jnp.asarray(ia), jnp.asarray(ib),
        n_limbs=jlb.FP.n_limbs, inv16=jlb.FP.inv16,
        p_limbs=tuple(int(v) for v in jlb.FP.p_limbs), n_terms=ia.shape[1],
        block_b=32, interpret=True, variant="vector")
    got = mont.fold_planned(convert.fp_to_torch(stack, "cpu"), ia, ib)
    assert got.shape == (len(ia), 24, NB)
    assert np.array_equal(convert.fp_from_torch(got), np.asarray(want))
    assert np.array_equal(
        convert.fp_from_torch(mont.fold_planned_plain(
            convert.fp_to_torch(stack, "cpu"), ia, ib)), np.asarray(want))


def recording(monkeypatch):
    """Patch mont.sop_rows to record each call's arguments: (spec, rows,
    ia, ib, counts, batch), the rows as the caller's tensor objects."""
    calls = []
    real = mont.sop_rows

    def spy(spec, rows, ia, ib, counts, batch, shape=None):
        calls.append((spec, list(rows), np.array(ia), np.array(ib),
                      np.array(counts), tuple(batch)))
        return real(spec, rows, ia, ib, counts, batch, shape)

    monkeypatch.setattr(mont, "sop_rows", spy)
    return calls


def make_groups(G, T, pool_j, pool_t):
    """G groups of 1..T terms (group 0 has exactly T) over a small operand
    pool, so operands repeat across and within groups."""
    groups_j, groups_t = [], []
    for g in range(G):
        n = T if g == 0 else rng.randint(1, T)
        idx = [(rng.randrange(len(pool_j)), rng.randrange(len(pool_j)))
               for _ in range(n)]
        groups_j.append([(pool_j[a], pool_j[b]) for a, b in idx])
        groups_t.append([(pool_t[a], pool_t[b]) for a, b in idx])
    return groups_j, groups_t


@pytest.mark.parametrize("G", [2, 3, 4, 8])
@pytest.mark.parametrize("T", [1, 2, 6, 8])
def test_dedup_route_matches_jax_sop_fold(monkeypatch, G, T):
    """Every Fp fold of two or more groups is one row-kernel call whose
    rows are the caller's distinct tensors themselves (no copy, no stack),
    each once, with the groups' own term counts."""
    pool = [both(rvals(NB)) for _ in range(5)]
    groups_j, groups_t = make_groups(G, T, [j for j, _ in pool],
                                     [t for _, t in pool])
    calls = recording(monkeypatch)
    got = limbs.sop_fold(limbs.FP, groups_t)
    want = jlb.sop_fold(jlb.FP, groups_j)
    for g, w in zip(got, want):
        assert np.array_equal(convert.fp_from_torch(g), np.asarray(w))
    assert len(calls) == 1
    spec, rows, ia, ib, counts, batch = calls[0]
    used = {id(x) for g in groups_t for pair in g for x in pair}
    assert spec is limbs.FP and batch == (NB,)
    assert len(rows) == len(used) == len({id(r) for r in rows})
    assert ia.shape == (G, T) and list(counts) == [len(g) for g in groups_t]
    for gi, g in enumerate(groups_t):
        for ti, (a, b) in enumerate(g):
            assert rows[ia[gi, ti]] is a and rows[ib[gi, ti]] is b


def test_dedup_route_broadcasts_operands(monkeypatch):
    """Operands of different batch shapes (a [24, 1, 1] constant,
    [24, 1, NB] rows, [24, 2, NB] stacks) broadcast as in the stacked
    route."""
    ja, _ = both(rvals(NB))
    ja = ja[:, None]
    jc = jfp.from_ints([7])[:, None]
    jw = jnp.concatenate([ja, ja[..., ::-1]], axis=1)
    ta, tc, tw_ = (convert.fp_to_torch(np.asarray(x), "cpu")
                   for x in (ja, jc, jw))
    groups_j = [[(ja, jc)], [(jw, ja)], [(jc, jc), (jw, jw)], [(ja, ja)]]
    groups_t = [[(ta, tc)], [(tw_, ta)], [(tc, tc), (tw_, tw_)], [(ta, ta)]]
    calls = recording(monkeypatch)
    got = limbs.sop_fold(limbs.FP, groups_t)
    want = jlb.sop_fold(jlb.FP, groups_j)
    assert len(calls) == 1
    for g, w in zip(got, want):
        assert g.shape == (24, 2, NB)
        assert np.array_equal(convert.fp_from_torch(g), np.asarray(w))


def test_dedup_route_splits_large_tables(monkeypatch):
    """A fold beyond the kernel's G T table cap runs as launches over
    chunks of groups, each within the cap."""
    T = 8
    G = mont.FOLD_ENTRIES // T + 3
    pool = [both(rvals(4)) for _ in range(3)]
    groups_j, groups_t = make_groups(G, T, [j for j, _ in pool],
                                     [t for _, t in pool])
    calls = recording(monkeypatch)
    got = limbs.sop_fold(limbs.FP, groups_t)
    want = jlb.sop_fold(jlb.FP, groups_j)
    assert [c[2].shape[0] for c in calls] == [G - 3, 3]
    assert all(c[2].size <= mont.FOLD_ENTRIES for c in calls)
    assert len(got) == G
    for g, w in zip(got, want):
        assert np.array_equal(convert.fp_from_torch(g), np.asarray(w))


@pytest.mark.parametrize("G", [2, 4])
def test_other_folds_take_the_stacked_route(monkeypatch, G):
    """Fr folds, which once stacked their operands per (group, term) for one
    product launch, take the row kernel too: one call over the caller's
    tensors, with the JAX package's values."""
    calls = recording(monkeypatch)
    pool = [both(rvals(NB, Q, [0, 1, Q - 1]), jfr) for _ in range(4)]
    # Fr chunks at 2 terms; keep each group within one
    groups_j, groups_t = make_groups(G, 1, [j for j, _ in pool],
                                     [t for _, t in pool])
    got = limbs.sop_fold(limbs.FR, groups_t)
    want = jlb.sop_fold(jlb.FR, groups_j)
    assert [(c[0], c[2].shape) for c in calls] == [(limbs.FR, (G, 1))]
    assert all(any(r is t for _, t in pool) for r in calls[0][1])
    for g, w in zip(got, want):
        assert np.array_equal(convert.fp_from_torch(g), np.asarray(w))


def test_fold_wrapper_validates_inputs():
    ops = torch.zeros((3, 24, 4), dtype=torch.int32)
    ok = np.zeros((4, 2), np.int32)
    bad = {
        "T > 8": (np.zeros((1, 9), np.int32),) * 2,
        "G T > the table": (np.zeros((65, 8), np.int32),) * 2,
        "index >= K": (np.full((4, 2), 3, np.int32), ok),
        "negative index": (ok, np.full((4, 2), -1, np.int32)),
        "shapes differ": (ok, np.zeros((4, 3), np.int32)),
        "not 2-D": (np.zeros(4, np.int32),) * 2,
    }
    for ia, ib in bad.values():
        with pytest.raises(ValueError):
            mont.fold_planned(ops, ia, ib)
    with pytest.raises(ValueError):
        mont.fold_planned(torch.zeros((3, 16, 4), dtype=torch.int32), ok, ok)
    with pytest.raises(ValueError, match="unsupported device"):
        mont.fold_planned(torch.zeros((3, 24, 4), dtype=torch.int32,
                                      device="meta"), ok, ok)
    assert mont.fold_planned(ops, ok, ok).shape == (4, 24, 4)


def mont_rows(shape, mod=P, jfield=jfp):
    """Random canonical Montgomery limbs [L, *shape], with edge lanes 0, 1,
    m-1 first where there are three lanes: (torch int32, numpy uint32) of
    the same values."""
    n = int(np.prod(shape))
    arr = np.asarray(jfield.from_ints(
        rvals(n, mod, [0, 1, mod - 1] if n >= 3 else [])))
    arr = arr.reshape(arr.shape[:1] + tuple(shape))
    return convert.fp_to_torch(arr, "cpu"), arr


def layout_groups(layout):
    """(spec, jax spec, groups of (port, jax) operand pairs, rows copied) of
    an operand layout a path hands to the row kernel: the port's operands
    are views and broadcasts of one tensor, the JAX package's the same
    values through numpy."""
    if layout == "line_scaling":
        # pairing.miller_loop_batched: movedim views of the [68, 3, 2, L, B]
        # coefficients (here [4, 3, 2, 24, 8]), yp and xp expanded over 68
        _, arr = mont_rows((4 * 3 * 2 * 8,))
        arr = np.ascontiguousarray(
            np.moveaxis(arr.reshape(24, 4, 3, 2, 8), 0, 3))
        coeffs = convert.fp_to_torch(arr, "cpu")
        (yt, ya), (xt, xa) = mont_rows((8,)), mont_rows((8,))
        ypb = (yt.unsqueeze(1).expand(24, 4, 8),
               np.broadcast_to(ya[:, None], (24, 4, 8)))
        xpb = (xt.unsqueeze(1).expand(24, 4, 8),
               np.broadcast_to(xa[:, None], (24, 4, 8)))
        comp = [(coeffs[:, i, j].movedim(1, 0), np.moveaxis(arr[:, i, j], 1, 0))
                for i, j in ((0, 0), (0, 1), (2, 0), (2, 1))]
        return limbs.FP, jlb.FP, [[(comp[0], ypb)], [(comp[1], ypb)],
                                  [(comp[2], xpb)], [(comp[3], xpb)]], 0
    if layout == "strided":
        # utils/scans.py: a product scan level over the 0::2 and 1::2 lanes
        t, a = mont_rows((2 * NB,))
        ev, od = (t[:, 0::2], a[:, 0::2]), (t[:, 1::2], a[:, 1::2])
        return limbs.FP, jlb.FP, [[(ev, od)], [(od, od), (ev, ev)]], 0
    if layout == "broadcast_n1":
        # batch_inv: the inverted total [L, n, 1] against [L, n, m]
        c, d = mont_rows((4, 1)), mont_rows((4, 8))
        return limbs.FP, jlb.FP, [[(c, d)], [(d, c), (c, c)]], 0
    if layout == "constant":
        # a [L, 1] constant (limbs._col, fr.const) against [L, B]
        k, d = mont_rows((1,)), mont_rows((NB,))
        return limbs.FP, jlb.FP, [[(k, d)], [(d, d), (k, k)]], 0
    if layout == "non_affine":
        # outer batch axes (3, 2) with strides (8, 24): one row is copied
        t, a = mont_rows((2, 3, 8))
        na = (t.transpose(1, 2), np.swapaxes(a, 1, 2))
        x = mont_rows((3, 2, 8))
        return limbs.FP, jlb.FP, [[(na, x)], [(x, x)]], 1
    assert layout == "fr_fold"
    # four Fr groups of two terms, a [16, 1] step constant among them
    k = mont_rows((1,), Q, jfr)
    pool = [mont_rows((NB,), Q, jfr) for _ in range(3)]
    return limbs.FR, jlb.FR, [[(pool[0], k), (pool[1], pool[2])],
                              [(k, k), (pool[2], pool[0])],
                              [(pool[1], pool[1])],
                              [(pool[2], k), (k, pool[0])]], 0


LAYOUTS = ["line_scaling", "strided", "broadcast_n1", "constant",
           "non_affine", "fr_fold"]


@pytest.mark.parametrize("route", ["fold", "sum"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_operands_read_in_place_match_jax(monkeypatch, layout, route):
    """Each layout through `sop_fold` (all its groups) and through
    `sum_of_products` (the first two groups' terms as one sum, at most one
    launch's worth): the JAX
    package's values, the caller's tensors as the kernel's rows, and only
    the non-affine operand counted in `copied_rows`."""
    spec, jspec, groups, copies = layout_groups(layout)
    if route == "sum":
        groups = [(groups[0] + groups[1])[:spec.max_terms]]
    port = [[(a[0], b[0]) for a, b in g] for g in groups]
    ref = [[(jnp.asarray(a[1]), jnp.asarray(b[1])) for a, b in g]
           for g in groups]
    calls = recording(monkeypatch)
    before = LAUNCHES.copied_rows
    if route == "sum":
        got = [limbs.sum_of_products(spec, port[0])]
        want = [jlb.sum_of_products(jspec, ref[0])]
    else:
        got = limbs.sop_fold(spec, port)
        want = jlb.sop_fold(jspec, ref)
    assert LAUNCHES.copied_rows - before == copies
    assert len(calls) == 1 and calls[0][0] is spec
    operands = {id(x) for g in port for pair in g for x in pair}
    assert {id(r) for r in calls[0][1]} == operands
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(convert.fp_from_torch(g), np.asarray(w))
