"""The plan kernel's fold mode on the card (`kernels/plan_exec.py`
`plan_fold`, `ops/msm.py` `_fold_sums`): every level equal to its plain
version word for word (totals, partials, content flags) on ragged
layouts; every MSM window at once against the per-window segmented scan
run on the card, equal as points (`eq`), from 2^5 to 2^22 lanes; the key
registry's sums (an Electra attestation's 24,576 keys, {pk, -pk}, a key
twice, the whole table) against the scan and the host; `kernels.BUCKETS`'
counts on the card.

Tolerance: none (integer arithmetic).  Every test needs a CUDA device:
without one it skips (the `gpu` marker).  From the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_bucket_fold_gpu.py
"""

import random

import numpy as np
import pytest
import torch

from bls12_381_torch import entry, hostmath as hm
from bls12_381_torch.curves import g1, g2
from bls12_381_torch.kernels import BUCKETS
from bls12_381_torch.kernels import plan_exec as pe
from bls12_381_torch.ops import aggregate, msm
from test_torch_aggregate import (affine_ints, compressed, flat, host_keys,
                                  host_sum)

pytestmark = pytest.mark.gpu
GROUPS = {"g1": g1, "g2": g2}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def affine_table(group, log_n, dev):
    """The affine (x, y) of msm_inputs' points [i+1]G (the identity at
    i % 64 == 5) and their packed table."""
    mod = GROUPS[group]
    pts, _ = entry.msm_inputs(log_n, group, device=dev)
    ax, ay, _ = mod.to_affine(pts)
    return (ax, ay), pe.pack_words([r for c in (ax, ay)
                                    for r in mod.CURVE.f.rows(c)])


def levels_of(group, table, order, dest, negs, n_out, levels):
    """Each level's (partials, content, dest) and the totals after it."""
    curve = GROUPS[group].CURVE
    f = curve.f
    ident = [r for c in curve.identity((n_out,), dest.device)
             for r in f.rows(c)]
    totals = torch.stack(ident).contiguous()
    width = len(ident) // 3
    fold = pe.Fold(table, dest, order, negs, (width, 2 * width),
                   one_mask=msm._identity_mask(curve))
    out = []
    for n, (_, M) in enumerate(levels):
        plan = pe.compile_plan(f.add_mixed_plan() if n == 0 else f.add_plan(),
                               fold=True)
        fold = pe.plan_fold(plan, fold, M, totals)
        out.append([t.cpu().clone() for t in (fold.src, fold.content,
                                              fold.dest, totals)])
    return out


def ragged(name: str, rng):
    if name == "own_segments":
        return list(range(300))
    if name == "one_segment":
        return [3] * 300
    if name == "bucket_0":
        return sorted(rng.choices(range(-1, 40), k=300))
    if name == "wide":
        return sorted(rng.choices(range(50), k=5000))
    return [0] * 3 + [1] * 17 + [2] + [4] * 9 + [7] * 10 + [9] * 64 + \
        [10] * 65


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("name", ["own_segments", "one_segment", "bucket_0",
                                  "wide", "run_edges"])
@pytest.mark.parametrize("runs", ["library", "four"])
def test_each_level_equals_the_plain_version(cuda, group, name, runs):
    """Every level's partials, content flags, dest and totals: kernel =
    plain version, word for word, at the library's run lengths and at
    runs of 4 lanes (more levels)."""
    rng = random.Random(f"{group}{name}")
    aff, table = affine_table(group, 10, "cpu")
    dest = ragged(name, rng)
    K = len(dest)
    good = [i for i in range(1024) if i % 64 != entry.MSM_IDENTITY_LANE]
    order = torch.tensor([rng.choice(good) for _ in range(K)])
    negs = torch.tensor([rng.random() < 0.5 for _ in range(K)])
    dest_t = torch.tensor(dest, dtype=torch.int64)
    if runs == "library":
        levels = msm.fold_levels(K)
    else:
        levels, k = [], K
        while k > 6:
            levels.append((k, 4))
            k = 2 * -(-k // 4)
        levels.append((k, k))
    card = levels_of(group, table.to(cuda), order.to(cuda), dest_t.to(cuda),
                     negs.to(cuda), max(dest) + 1, levels)
    plain = levels_of(group, table, order, dest_t, negs, max(dest) + 1,
                      levels)
    for n, (a, b) in enumerate(zip(card, plain)):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), n


@pytest.mark.parametrize("lanes", [4, 64, 1024, 1 << 14, 1 << 17,
                                   (1 << 22) // 11])
def test_all_windows_fold_equals_the_scan(cuda, monkeypatch, lanes):
    """Eleven windows of sorted signed digits (c = 12; from 44 to 2^22
    lanes in all) over a table of 2^16 points, the identity's lanes in
    bucket 0 as the recode puts them: the fold's buckets of every window
    at once = each window's segmented scan run on the card (`eq`)."""
    c, n_win = 12, 11
    half = 1 << (c - 1)
    aff, _ = affine_table("g1", 16, cuda)
    gen = torch.Generator(device=cuda).manual_seed(lanes)
    order = torch.randint(0, 1 << 16, (n_win, lanes), generator=gen,
                          device=cuda)
    mags = torch.randint(0, half + 1, (n_win, lanes), generator=gen,
                         device=cuda, dtype=torch.int32)
    mags = mags.masked_fill(order % 64 == entry.MSM_IDENTITY_LANE, 0)
    negs = torch.randint(0, 2, (n_win, lanes), generator=gen,
                         device=cuda).bool()
    idx = torch.argsort(mags, dim=-1, stable=True)
    digits = tuple(torch.take_along_dim(t, idx, dim=-1)
                   for t in (order, mags, negs))
    before = BUCKETS.snapshot()
    folded = msm._all_window_buckets(msm.G1, aff, digits, c)
    assert BUCKETS.since(before) == {
        "fold": 1, "scan": 0, "lanes": n_win * lanes,
        "levels": len(msm.fold_levels(n_win * lanes))}
    monkeypatch.setattr(msm, "_on_card", lambda t: False)
    for w in range(n_win):
        scanned = msm._window_buckets(msm.G1, aff, *(t[w] for t in digits),
                                      c)
        assert bool(g1.eq(folded[w], scanned).all()), w
    assert BUCKETS.since(before)["scan"] == n_win


@pytest.fixture(scope="module")
def registry(cuda):
    """[i+1]G1 for i < 2^15, then -G1 (key 2^15)."""
    keys = host_keys(1 << 15)
    keys.append(hm.g1_neg(keys[0]))
    reg = aggregate.KeyRegistry(cuda)
    assert reg.register(compressed(keys)).all()
    return reg


def test_registry_fold_equals_the_scan_and_the_host(registry, monkeypatch):
    """An epoch's shapes: an attestation's 24,576 keys, {pk, -pk} (the
    identity), a key twice, singletons, empty sets and the whole table;
    the fold = the host's sums and = the scan run on the card."""
    n = len(registry) - 1
    rng = np.random.default_rng(23)
    sets = [np.sort(rng.choice(n, 24576, replace=False)).tolist(), [0, n],
            [], [7, 7, 3], [5], list(range(n)), [n, 0, 9], []]
    before = BUCKETS.snapshot()
    apk, filled = registry.aggregate(*flat(sets))
    keys = sum(map(len, sets))
    assert BUCKETS.since(before) == {"fold": 1, "scan": 0, "lanes": keys,
                                     "levels": len(msm.fold_levels(keys))}
    assert filled.tolist() == [len(s) > 0 for s in sets]
    # key n is -[1]G1: its index stands for -1 in the host's sum
    want = host_sum([[-1 - 1 if i == n else i for i in s] for s in sets])
    assert affine_ints(tuple(t.cpu() for t in apk)) == want
    assert want[1] is None
    monkeypatch.setattr(msm, "_on_card", lambda t: False)
    scanned, _ = registry.aggregate(*flat(sets))
    assert bool(g1.eq(apk, scanned).all())
    assert BUCKETS.since(before)["scan"] == 1
