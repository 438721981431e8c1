"""The bucket sums' fold on the CPU: `ops/msm.py` `_fold_sums` over
`kernels/plan_exec.py` `plan_fold`, whose plain version walks the same
partition as the plan kernel's fold mode.  Its partition (the lanes each
folder walks, the totals and the two partials each run leaves, their
content flags and dest, the levels) is held to a model written here; its
sums to the segmented scan (`msm.segment_sums` on the CPU) and the host
oracle on ragged layouts; the MSM and the key registry run through it
with `kernels.BUCKETS` counting.

Points are P_i = [i+1]G of `entry.msm_inputs` (the identity at i % 64 ==
5, only in dropped segments), so a lane of order o adds [+-(o+1)]G and
every sum is known on the host.  Tolerance: none (integer arithmetic).
"""

import random

import numpy as np
import pytest
import torch

from bls12_381_torch import entry, hostmath as hm, params
from bls12_381_torch.curves import g1, g2
from bls12_381_torch.kernels import BUCKETS
from bls12_381_torch.kernels import plan_exec as pe
from bls12_381_torch.ops import aggregate, msm

torch.set_num_threads(1)
GROUPS = {"g1": (g1, hm.g1_mul, params.G1_GEN),
          "g2": (g2, hm.g2_mul, params.G2_GEN)}
N_POINTS = 64
IDENTITY_LANE = entry.MSM_IDENTITY_LANE


@pytest.fixture(scope="module")
def tables():
    """Per group: the affine (x, y) of msm_inputs' 64 points and their
    `pack_words` table."""
    out = {}
    for group, (mod, _, _) in GROUPS.items():
        pts, _ = entry.msm_inputs(6, group, device="cpu")
        ax, ay, _ = mod.to_affine(pts)
        rows = [r for c in (ax, ay) for r in mod.CURVE.f.rows(c)]
        out[group] = ((ax, ay), pe.pack_words(rows))
    return out


def host_point(group, k: int):
    _, mul, gen = GROUPS[group]
    k %= params.Q
    return None if k == 0 else mul(gen, k)


def affine(group, point) -> list:
    """Projective points [n] -> host affine points (None: the identity)."""
    mod = GROUPS[group][0]
    x, y, inf = mod.to_affine(point)
    rows = [r for c in (x, y) for r in mod.CURVE.f.rows(c)]
    ints = [[int(v) for v in limbs_ints(r)] for r in rows]
    width = len(rows) // 2
    out = []
    for s in range(len(inf)):
        if inf[s]:
            out.append(None)
        elif width == 1:
            out.append((ints[0][s], ints[1][s]))
        else:
            out.append(((ints[0][s], ints[1][s]), (ints[2][s], ints[3][s])))
    return out


def limbs_ints(row) -> list:
    """[24, n] Montgomery limbs -> canonical Python ints."""
    from bls12_381_torch.fields import fp
    return fp.to_ints(row)


def lane_value(order, negs, i: int) -> int:
    """The multiple of G that lane i adds."""
    v = int(order[i]) + 1
    return -v if negs is not None and bool(negs[i]) else v


def model_partition(dest: list, M: int):
    """What one level leaves, written out: per run r (lanes [rM, rM + M))
    its pieces (maximal runs of equal dest inside it); a piece open on
    neither side is its segment's total, the first piece open on the left
    is partial 2r, the last open on the right (and not that one) partial
    2r + 1; a partial without a piece is empty.  Returns (totals {dest:
    lanes}, partials [(dest, lanes or None)] * 2 runs)."""
    K = len(dest)
    totals, partials = {}, []
    for r0 in range(0, K, M):
        r1 = min(r0 + M, K)
        pieces, a = [], r0
        for i in range(r0 + 1, r1 + 1):
            if i == r1 or dest[i] != dest[a]:
                pieces.append(list(range(a, i)))
                a = i
        first = last = None
        for p in pieces:
            open_left = p[0] > 0 and dest[p[0] - 1] == dest[p[0]]
            open_right = p[-1] + 1 < K and dest[p[-1] + 1] == dest[p[-1]]
            if p[0] == r0 and open_left:
                first = p
            elif p[-1] == r1 - 1 and open_right:
                last = p
            else:
                assert not open_left and not open_right
                totals[dest[p[0]]] = p
        partials += [(dest[r0], first), (dest[r1 - 1], last)]
    return totals, partials


def fold_once(group, table, order, dest, negs, M, n_out):
    """One level over the lanes (the mixed addition's plan)."""
    mod = GROUPS[group][0]
    curve = mod.CURVE
    ident = [r for c in curve.identity((n_out,), "cpu")
             for r in curve.f.rows(c)]
    totals = torch.stack(ident).contiguous()
    width = len(ident) // 3
    fold = pe.Fold(table, torch.tensor(dest, dtype=torch.int64),
                   torch.tensor(order), negs, (width, 2 * width),
                   one_mask=msm._identity_mask(curve))
    plan = pe.compile_plan(curve.f.add_mixed_plan(), fold=True)
    nxt = pe.plan_fold(plan, fold, M, totals)
    return totals, nxt


def as_points(group, rows):
    """[3 w, 24, n] rows -> projective points [n]."""
    f = GROUPS[group][0].CURVE.f
    rows = list(rows.unbind(0))
    w = len(rows) // 3
    return tuple(f.from_rows(rows[k:k + w]) for k in range(0, len(rows), w))


PARTITIONS = {
    "crafted": ([0] * 6 + [1] * 7 + [2] + [3] * 4 + [5] * 6, 4),
    "own_segments": (list(range(10)), 4),
    "one_segment": ([7] * 21, 4),
    "ragged_long": (sorted(random.Random(3).choices(range(9), k=27)), 8),
}


@pytest.mark.parametrize("name", sorted(PARTITIONS))
def test_one_level_leaves_the_model_partition(tables, name):
    """One level of the plain fold: totals written exactly for the pieces
    that are whole segments, each partial's dest, content flag and sum as
    the model says, an empty partial the identity."""
    dest, M = PARTITIONS[name]
    K = len(dest)
    rng = random.Random(K)
    order = [rng.choice([o for o in range(N_POINTS)
                         if o % 64 != IDENTITY_LANE]) for _ in range(K)]
    negs = torch.tensor([rng.random() < 0.5 for _ in range(K)])
    n_out = max(dest) + 2
    totals, nxt = fold_once("g1", tables["g1"][1], order, dest, negs, M,
                            n_out)
    want_totals, want_parts = model_partition(dest, M)
    assert nxt.dest.tolist() == [d for d, _ in want_parts]
    assert nxt.content.tolist() == [p is not None for _, p in want_parts]
    got = affine("g1", as_points("g1", totals))
    for j in range(n_out):
        lanes = want_totals.get(j)
        want = None if lanes is None else host_point(
            "g1", sum(lane_value(order, negs, i) for i in lanes))
        assert got[j] == want, j
    parts = affine("g1", as_points("g1", pe.unpack_words(nxt.src)))
    for s, (_, lanes) in enumerate(want_parts):
        want = None if lanes is None else host_point(
            "g1", sum(lane_value(order, negs, i) for i in lanes))
        assert parts[s] == want, s


def test_fold_levels():
    """The levels' run lengths: M = K / FOLD_FOLDERS as a power of two in
    [8, 64], 2 ceil(K / M) lanes left, one folder at 16 lanes or fewer;
    the blob's (4096 points, 11 windows of 8192 GLV lanes) and 2^20
    points' levels written out."""
    assert msm.fold_levels(1) == [(1, 1)]
    assert msm.fold_levels(16) == [(16, 16)]
    assert msm.fold_levels(17) == [(17, 8), (6, 6)]
    assert msm.fold_levels(11 << 13) == [
        (90112, 8), (22528, 8), (5632, 8), (1408, 8), (352, 8), (88, 8),
        (22, 8), (6, 6)]
    assert msm.fold_levels(11 << 21) == [
        (23068672, 64), (720896, 32), (45056, 8), (11264, 8), (2816, 8),
        (704, 8), (176, 8), (44, 8), (12, 12)]
    for K in list(range(1, 400)) + [10 ** 6, 3 << 22, 1 << 30]:
        levels = msm.fold_levels(K)
        assert levels[0][0] == K and levels[-1][0] == levels[-1][1] <= 16
        for (k, m), (k_next, _) in zip(levels, levels[1:]):
            assert m in (8, 16, 32, 64) and k_next == 2 * -(-k // m) < k


def layout(name: str, rng):
    """(dest, order, negs, n_out) of a ragged layout over the 64 points;
    lanes with dest outside [0, n_out) are dropped (bucket 0)."""
    good = [o for o in range(N_POINTS) if o % 64 != IDENTITY_LANE]
    if name == "own_segments":
        dest = list(range(24))
    elif name == "one_segment_across_runs":
        dest = [4] * 40
    elif name == "empty_buckets":
        dest = sorted(rng.choices([0, 3, 9, 10], k=36))
    elif name == "bucket_0":
        dest = sorted(rng.choices(range(-1, 7), k=40))
    elif name == "window_boundary_inside_a_run":
        # two windows of 29 sorted lanes, buckets 0..7 each: bucket b of
        # window w is output 9 w + b, bucket 0 dropped after the sum
        dest = [9 * w + b for w in range(2)
                for b in sorted(rng.choices(range(8), k=29))]
    elif name == "a_point_twice":
        dest = [0, 0, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2]
        order = [3, 3, 4, 4, 4, 6, 6, 7, 6, 6, 8, 8, 8, 8]
        return dest, order, torch.zeros(len(dest), dtype=torch.bool), 3
    elif name == "p_and_minus_p":
        dest = [0, 0, 1, 1, 1] + [2] * 10 + [3] * 4
        order = [3, 3, 4, 4, 9] + [6] * 10 + [7, 8, 7, 8]
        negs = [False, True, True, False, False] + [False, True] * 5 + \
            [False, False, True, True]
        return dest, order, torch.tensor(negs), 4
    else:
        raise ValueError(name)
    # the identity only in dropped segments (bucket 0), as the MSM has it
    order = [o if d < 0 or o % 64 != IDENTITY_LANE else rng.choice(good)
             for d, o in zip(dest, rng.choices(range(N_POINTS),
                                               k=len(dest)))]
    negs = torch.tensor([rng.random() < 0.5 for _ in dest])
    return dest, order, negs, max(dest) + 2


LAYOUTS = ["own_segments", "one_segment_across_runs", "empty_buckets",
           "bucket_0", "window_boundary_inside_a_run", "a_point_twice",
           "p_and_minus_p"]


@pytest.mark.parametrize("group,name", [("g1", n) for n in LAYOUTS]
                         + [("g2", "p_and_minus_p")])
def test_fold_equals_the_scan(tables, monkeypatch, group, name):
    """Every level of the fold (runs of 4 to 8 lanes, so a segment crosses
    runs and levels) against the segmented scan (`eq`: equal as affine
    points) and the host's sums; a dropped segment is summed and not
    written."""
    monkeypatch.setattr(msm, "FOLD_FOLDERS", 1)
    monkeypatch.setattr(msm, "FOLD_RUNS", (4, 8))
    monkeypatch.setattr(msm, "FOLD_LAST", 4)
    mod = GROUPS[group][0]
    aff, table = tables[group]
    dest, order, negs, n_out = layout(name, random.Random(name))
    dest_t = torch.tensor(dest, dtype=torch.int64)
    order_t = torch.tensor(order)
    folded, levels = msm._fold_sums(mod, table, order_t, dest_t, n_out, negs)
    assert levels == len(msm.fold_levels(len(dest))) > 1
    scanned = msm.segment_sums(mod, aff, order_t, dest_t, n_out, negs)
    want = [host_point(group, sum(lane_value(order, negs, i)
                                  for i, d in enumerate(dest) if d == j))
            for j in range(n_out)]
    assert bool(mod.eq(folded, scanned).all())
    assert affine(group, folded) == want


def test_msm_and_the_registry_through_the_fold(monkeypatch):
    """msm_g1 and KeyRegistry.aggregate with the card's route taken on CPU
    tensors: one fold over every window's lanes, equal to the scan's
    per-window buckets (`eq`), the MSM to the host's point, the key
    sums to the host's; BUCKETS counts each fold call with its lanes and
    levels, and the CPU route's scan calls."""
    import port_cases

    pts, sc = entry.msm_inputs(3, "g1", seed=5, device="cpu")
    c = 6
    windows = -(-129 // c)
    aff, mags, negs = msm._recode_g1(pts, sc, c, True)
    digits = msm._sort_digits(mags, negs)
    before = BUCKETS.snapshot()
    per_window = [msm._window_buckets(msm.G1, aff, digits[0][w],
                                      digits[1][w], digits[2][w], c)
                  for w in range(windows)]
    assert BUCKETS.since(before) == {"fold": 0, "scan": windows,
                                     "lanes": 0, "levels": 0}
    monkeypatch.setattr(msm, "_on_card", lambda t: True)
    before = BUCKETS.snapshot()
    folded = msm._all_window_buckets(msm.G1, aff, digits, c)
    lanes = windows * 16
    assert BUCKETS.since(before) == {
        "fold": 1, "scan": 0, "lanes": lanes,
        "levels": len(msm.fold_levels(lanes))}
    assert all(bool(g1.eq(a, b).all()) for a, b in zip(folded, per_window))
    got = msm.msm_g1(pts, sc, c)
    assert affine("g1", tuple(t[..., None] for t in got)) == \
        [port_cases.msm_host("g1", pts, sc)]

    keys = [hm.g1_mul(params.G1_GEN, k) for k in (3, 5, 11)]
    keys.append(hm.g1_neg(keys[0]))
    reg = aggregate.KeyRegistry("cpu")
    assert reg.register(np.array([np.frombuffer(hm.g1_to_compressed(p),
                                                np.uint8)
                                  for p in keys])).all()
    sets = [[0, 3], [], [1, 1, 2], [3, 0, 1]]
    idx = np.array([i for s in sets for i in s])
    off = np.cumsum([0] + [len(s) for s in sets])
    before = BUCKETS.snapshot()
    apk, filled = reg.aggregate(idx, off)
    assert BUCKETS.since(before)["fold"] == 1
    assert BUCKETS.since(before)["lanes"] == len(idx)
    assert filled.tolist() == [True, False, True, True]
    assert affine("g1", apk) == [None, None, host_point("g1", 21),
                                 host_point("g1", 5)]
