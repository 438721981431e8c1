"""The validator key registry and its sums (`ops/aggregate.py`) on the
CPU: registration refuses the identity, points outside G1 and malformed
encodings and keeps the rest in order; ragged sums by index (empty sets,
one key, a key twice, a key and its negation, the whole table) equal the
host's; FastAggregateVerify composed from the program's public functions
gives the plain reference's verdict (`portbench/reference/aggregate.py`)
for an honest set and every invalid kind; the MSM and the sums share one
segmented sum; the spans nest and `AGGREGATES` counts.

Keys are P_i = [i+1]G1 made on the host, so a set's sum is
[sum (i+1)]G1.  Tolerance: none (integer arithmetic).
"""

import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from bls12_381_torch import entry, hostmath as hm, pairing, params
from bls12_381_torch.curves import g1, g2
from bls12_381_torch.fields import fp, tower
from bls12_381_torch.hash_to_curve import h2c
from bls12_381_torch.kernels import AGGREGATES
from bls12_381_torch.ops import aggregate, msm
from bls12_381_torch.utils import profiling, scans

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "portbench"))
from reference import aggregate as reference  # noqa: E402

torch.set_num_threads(1)
N_KEYS = 12
DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"


def host_keys(n: int) -> list:
    """[i+1]G1 for i < n, affine on the host."""
    pts, p = [], None
    for _ in range(n):
        p = hm.g1_add(p, params.G1_GEN)
        pts.append(p)
    return pts


def compressed(points) -> np.ndarray:
    return np.array([np.frombuffer(hm.g1_to_compressed(p), np.uint8)
                     for p in points])


def flat(sets):
    """(indices int32, offsets) of index lists, back to back."""
    idx = np.array([i for s in sets for i in s], dtype=np.int32)
    return idx, np.cumsum([0] + [len(s) for s in sets])


def affine_ints(point) -> list:
    """Projective G1 points [S] -> [(x, y) or None] on the host."""
    if point[0].shape[-1] == 0:
        return []
    x, y, inf = g1.to_affine(point)
    xs, ys = fp.to_ints(x), fp.to_ints(y)
    return [None if inf[s] else (int(xs[s]), int(ys[s]))
            for s in range(len(inf))]


def host_sum(sets) -> list:
    """[sum_(i in set) (i+1)]G1 of each set, the key P_i = [i+1]G1."""
    return [hm.g1_mul(params.G1_GEN, sum(i + 1 for i in s) % params.Q)
            for s in sets]


@pytest.fixture(scope="module")
def registry():
    reg = aggregate.KeyRegistry("cpu")
    assert reg.register(compressed(host_keys(N_KEYS))).all()
    return reg


def malformed() -> dict:
    """Encodings register must refuse, by name."""
    good = hm.g1_to_compressed(params.G1_GEN)
    p_bytes = bytearray(params.P.to_bytes(48, "big"))
    p_bytes[0] |= 0x80
    x = 1
    while hm.fp_sqrt((x ** 3 + params.B_G1) % params.P) is not None:
        x += 1
    off_curve = bytearray(x.to_bytes(48, "big"))
    off_curve[0] |= 0x80
    inf_x = bytearray(hm.g1_to_compressed(None))
    inf_x[-1] = 1
    return {"identity": hm.g1_to_compressed(None),
            "outside_g1": hm.g1_to_compressed(hm.g1_point_outside_subgroup()),
            "no_compression_flag": bytes([good[0] & 0x7F]) + good[1:],
            "infinity_with_x": bytes(inf_x),
            "infinity_with_sort": bytes([0xE0]) + bytes(47),
            "x_not_below_p": bytes(p_bytes),
            "x_off_curve": bytes(off_curve)}


def test_register_refuses_invalid_keys_and_keeps_order():
    keys = host_keys(5)
    bad = malformed()
    rows = [hm.g1_to_compressed(keys[0]), bad["identity"],
            hm.g1_to_compressed(keys[1]), bad["outside_g1"],
            bad["no_compression_flag"], hm.g1_to_compressed(keys[2]),
            bad["infinity_with_x"], bad["infinity_with_sort"],
            bad["x_not_below_p"], bad["x_off_curve"]]
    reg = aggregate.KeyRegistry("cpu")
    taken = reg.register(np.array([np.frombuffer(r, np.uint8)
                                   for r in rows]))
    assert taken.tolist() == [True] + [False] + [True] + [False] * 2 + \
        [True] + [False] * 4
    assert len(reg) == 3
    # a second call appends after the first
    assert reg.register(compressed(keys[3:])).all()
    assert len(reg) == 5
    x, y = reg.xy
    assert list(zip(fp.to_ints(x), fp.to_ints(y))) == keys
    with pytest.raises(ValueError, match=r"uint8 \[n, 48\]"):
        reg.register(np.zeros((2, 96), np.uint8))


LAYOUTS = {
    "ragged": [[], [3], [0, 1, 2], [], [5, 5], [11, 4, 7, 8], []],
    "whole_table": [list(range(N_KEYS)), [6]],
    "one_key_each": [[i] for i in range(N_KEYS)],
    "all_empty": [[], [], []],
    "no_sets": [],
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_aggregate_ragged_sets_equal_host_sums(registry, layout):
    sets = LAYOUTS[layout]
    before = AGGREGATES.snapshot()
    apk, filled = registry.aggregate(*flat(sets))
    assert filled.tolist() == [len(s) > 0 for s in sets]
    assert affine_ints(apk) == host_sum(sets)
    assert AGGREGATES.snapshot() == {
        "calls": before["calls"] + 1, "sets": before["sets"] + len(sets),
        "keys": before["keys"] + sum(map(len, sets))}


def test_aggregate_of_a_key_and_its_negation_is_the_identity():
    p = host_keys(3)[2]
    reg = aggregate.KeyRegistry("cpu")
    assert reg.register(compressed([p, hm.g1_neg(p), p])).all()
    apk, filled = reg.aggregate(*flat([[0, 1], [0, 2, 1], [1]]))
    assert filled.tolist() == [True] * 3
    assert g1.is_identity(apk).tolist() == [True, False, False]
    assert affine_ints(apk)[1:] == [p, hm.g1_neg(p)]


@pytest.mark.parametrize("indices, offsets, match", [
    ([0, 1], [0, 1], "offsets must run"),
    ([0, 1], [1, 2], "offsets must run"),
    ([0, 1], [0, 2, 1, 2], "offsets must run"),
    ([0, 1], [], "offsets must run"),
    ([0, N_KEYS], [0, 2], r"indices must lie in \[0, 12\)"),
    ([-1, 0], [0, 2], "indices must lie"),
    ([0.0, 1.0], [0, 2], "1-D integer array"),
    ([[0, 1]], [0, 2], "1-D integer array"),
])
def test_aggregate_refuses_out_of_range_input(registry, indices, offsets,
                                              match):
    with pytest.raises(ValueError, match=match):
        registry.aggregate(np.array(indices), np.array(offsets))


def test_msm_and_aggregate_share_one_segmented_sum(registry, monkeypatch):
    """Every MSM window's buckets and every aggregate call go through
    `msm.segment_sums`, the aggregate's with its stage spans."""
    stages = []
    shared = msm.segment_sums

    def counted(*args, **kw):
        stages.append(kw.get("stage"))
        return shared(*args, **kw)

    monkeypatch.setattr(msm, "segment_sums", counted)
    pts, k = entry.msm_inputs(3, "g1", device="cpu")
    msm.msm_g1(pts, k, 4)
    windows = len(stages)
    assert windows == -(-129 // 4) and set(stages) == {None}
    registry.aggregate(*flat([[1, 2], [3]]))
    assert stages[windows:] == ["agg"]


def test_spans_nest_and_count_launches(registry):
    sets = [[0, 4], [], [9, 10, 11]]
    profiling.clear()
    try:
        with autograd_profiler.emit_itt():
            registry.aggregate(*flat(sets))
        spans = profiling.spans()
    finally:
        profiling.clear()
    assert [s["name"] for s in spans] == ["agg", "agg.gather", "agg.sum"]
    top, gather, total = spans
    assert top["parent"] is None
    assert gather["parent"] == total["parent"] == top["id"]
    assert top["start_ns"] <= gather["start_ns"] <= gather["end_ns"] <= \
        total["start_ns"] <= total["end_ns"] <= top["end_ns"]
    # the plain versions launch nothing; on the card the counter covers
    # the scan's plan launches (tests/test_torch_aggregate_gpu.py)
    assert all(s["launches"] == 0 for s in spans)
    # a card path: it gives the graphs' pools back where it runs out
    assert aggregate.KeyRegistry.aggregate.releases_graphs


# ---------------------------------------------------------------------------
# FastAggregateVerify from the program's public functions
# ---------------------------------------------------------------------------


def fast_aggregate_verify(registry, sets, msgs, sig_bytes, device="cpu"):
    """Verdicts of S sets: the registry's key sums, KeyValidate of each
    (non-empty, not the identity), the signatures parsed with the subgroup
    check, H(m), one pairing over [apk | G1] x [H(m) | sig], Gt compared."""
    n = len(sets)
    apk, filled = registry.aggregate(*flat(sets))
    key_ok = filled & ~g1.is_identity(apk)
    apk_aff = g1.to_affine(apk)
    sig_aff, sig_ok = g2.from_compressed_host(sig_bytes, device=device)
    parsed = torch.from_numpy(sig_ok).to(device)
    sig_aff = sig_aff[:2] + (sig_aff[2] | ~parsed,)
    h = g2.to_affine(h2c.hash_to_curve_g2(msgs, DST, expand="device",
                                          device=device))
    ps = scans.tree_map(lambda a, b: torch.cat([a, b], -1), apk_aff,
                        g1.generator_affine((n,), device))
    qs = scans.tree_map(lambda a, b: torch.cat([a, b], -1), h, sig_aff)
    f = pairing.pairing(ps, qs)
    equal = tower.fp12_eq(scans.tree_map(lambda t: t[..., :n], f),
                          scans.tree_map(lambda t: t[..., n:], f))
    return (parsed & key_ok & equal).cpu().numpy()


def signature(msg: bytes, scalar: int) -> bytes:
    return hm.g2_to_compressed(hm.g2_mul(hm.hash_to_curve_g2(msg, DST),
                                         scalar % params.Q))


def verify_cases(n_keys: int):
    """(sets, msgs uint8 [S, 32], signatures uint8 [S, 96], labels) over a
    registry of [i+1]G1 for i < n_keys whose last entry is -[1]G1: an
    honest set, one honest key, and each invalid kind."""
    rng = np.random.default_rng(7)
    msgs = rng.integers(0, 256, (8, 32), dtype=np.uint8)
    m = [bytes(r) for r in msgs]
    neg = n_keys - 1  # the negation of key 0

    def weight(s):
        return sum(i + 1 for i in s)

    outside = hm.g2_to_compressed(hm.g2_point_outside_subgroup())
    flipped = bytearray(signature(m[4], weight([0, 9])))
    flipped[17] ^= 0x10
    cases = [  # (set, signature, valid)
        ([0, 2, 5], signature(m[0], weight([0, 2, 5])), True),
        ([3], signature(m[1], 4), True),
        ([1, 3], signature(b"another message", weight([1, 3])), False),
        ([4, 6, 7], signature(m[3], weight([4, 6])), False),
        ([8], outside, False),
        ([0, 9], bytes(flipped), False),
        ([0, neg], hm.g2_to_compressed(None), False),
        ([], hm.g2_to_compressed(None), False),
    ]
    sets = [c[0] for c in cases]
    sigs = np.array([np.frombuffer(c[1], np.uint8) for c in cases])
    return sets, msgs, sigs, [c[2] for c in cases]


def test_fast_aggregate_verify_matches_the_reference():
    keys = host_keys(10)
    reg = aggregate.KeyRegistry("cpu")
    assert reg.register(compressed(keys + [hm.g1_neg(keys[0])])).all()
    sets, msgs, sigs, labels = verify_cases(11)
    got = fast_aggregate_verify(reg, sets, msgs, sigs)
    enc = compressed(keys + [hm.g1_neg(keys[0])])
    want = [reference.fast_aggregate_verify(
        [enc[i].tobytes() for i in s], msgs[j].tobytes(), sigs[j].tobytes(),
        DST) for j, s in enumerate(sets)]
    assert want == labels
    assert got.tolist() == labels
    # the pairing alone accepts the key and its negation with the identity
    # as signature: only KeyValidate of the sum refuses it
    assert Counter(map(bool, got)) == {True: 2, False: 6}
