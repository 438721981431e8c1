"""The verify path's CUDA graphs on the card (`utils/graphs.py`, `graphed`):
the pairing, the hash and encode to curve functions and the compressed
decoders' device part replay their graph from the second call at a shape,
and every replay must equal the eager call limb for limb, at the
benchmark's shapes (pairings over 256, 8,192 and 704 lanes; hashes and
decoders over 128, 4,096 and 352), the decoders over every invalid kind
the benchmark sends; `hash_to_curve_g2` and the others on replay give the
draft's KATs; a replayed pairing counts `chip_smoke.expected_launches()`;
the stage spans of a replay are children of its replay span; a verify
call's graphs are all kept across calls; replays from two streams keep
their order; the graphs are released where the card runs out of memory.

Tolerance: none (integer arithmetic).  Every test needs a CUDA device:
without one it skips (the `gpu` marker).  From the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_verify_graph_gpu.py
"""

import collections
import gc
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from bls12_381_torch import entry, hostmath as hm, params
from bls12_381_torch.curves import g1, g2
from bls12_381_torch.hash_to_curve import h2c
from bls12_381_torch.kernels import GRAPHS, LAUNCHES
from bls12_381_torch.pairing.pairing import pairing
from bls12_381_torch.utils import graphs, profiling, scans
from test_torch_msm_graph_gpu import counts, equal, fill_to_cap

pytestmark = pytest.mark.gpu
DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"
KATS = Path(__file__).parent / "vectors" / "h2c_kats.json"
GROUPS = {"g1": g1, "g2": g2}
# the lanes of each encoding set that are invalid, by kind, mod 64
OUTSIDE, FLIPPED, X_TOO_LARGE, IDENTITY = 3, 7, 11, 13


@pytest.fixture
def cuda(monkeypatch):
    """The card, with no shape remembered and GRAPHS at zero; every graph
    made in the test is released after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(graphs, "_graphs", collections.OrderedDict())
    GRAPHS.reset()
    yield torch.device("cuda", 0)
    graphs._graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()


def eager(fn, *args, **kwargs):
    """fn's eager call (a first call at every shape), the graphs kept
    aside meanwhile; GRAPHS not counted."""
    kept, before = graphs._graphs, GRAPHS.snapshot()
    graphs._graphs = collections.OrderedDict()
    try:
        return fn(*args, **kwargs)
    finally:
        graphs._graphs = kept
        for name, value in before.items():
            setattr(GRAPHS, name, value)


def same(a, b) -> bool:
    """Equal limbs and masks, numpy arrays included."""
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return equal(a, b)


def points(group: str, n: int, k: int, dev):
    """Projective [2^k (i+1)]G over n lanes (the identity at i % 64 ==
    5), made on the card."""
    mod = GROUPS[group]
    log_n = max(n - 1, 1).bit_length()
    pts, _ = entry.msm_inputs(log_n, group, device=dev)
    pts = scans.tree_map(lambda t: t[..., :n].contiguous(), pts)
    for _ in range(k):
        pts = mod.double(pts)
    return pts


def pairing_set(n: int, k: int, dev):
    return (g1.to_affine(points("g1", n, k, dev)),
            g2.to_affine(points("g2", n, k + 1, dev)))


def encodings(group: str, n: int, k: int, dev) -> np.ndarray:
    """Compressed points of `points`, with, in every 64 lanes from lane
    k, a point outside the subgroup, a flipped body bit, an x >= p and
    the identity."""
    mod = GROUPS[group]
    data = mod.to_compressed_host(mod.to_affine(points(group, n, k, dev)))
    width = data.shape[1]
    outside = (hm.g1_to_compressed(hm.g1_point_outside_subgroup())
               if group == "g1" else
               hm.g2_to_compressed(hm.g2_point_outside_subgroup()))
    too_large = bytearray(params.P.to_bytes(48, "big") * (width // 48))
    too_large[0] |= 0x80
    for base in range(0, n, 64):
        lane = base + (k % 64)
        for kind, enc in ((OUTSIDE, outside), (X_TOO_LARGE, too_large),
                          (IDENTITY, bytes([0xC0]) + bytes(width - 1))):
            if lane + kind < n:
                data[lane + kind] = np.frombuffer(bytes(enc), np.uint8)
        if lane + FLIPPED < n:
            data[lane + FLIPPED, 1 + (lane % (width - 1))] ^= 1 << (lane % 8)
    return data


def invalid_lanes(n: int, k: int) -> set:
    return {base + (k % 64) + kind for base in range(0, n, 64)
            for kind in (OUTSIDE, FLIPPED, X_TOO_LARGE)
            if base + (k % 64) + kind < n}


def check_replays(fn, inputs, want):
    """Calls on inputs 0, 1, 0, 1: the first eager, the second captures,
    then replays; each equal to its eager value."""
    for i, j in enumerate((0, 1, 0, 1)):
        assert same(fn(*inputs[j]), want[j]), f"call {i}"
    assert GRAPHS.snapshot() == counts(1, 3, 1)


@pytest.mark.parametrize("n", [256, 8192, 704])
def test_pairing_replays_equal_eager(cuda, n):
    sets = [pairing_set(n, k, cuda) for k in range(2)]
    want = [eager(pairing, *s) for s in sets]
    check_replays(pairing, sets, want)
    # what a caller holds is its own: a later replay leaves it as it was
    first = pairing(*sets[0])
    keep = [t.clone() for t in scans.tree_leaves(first)]
    pairing(*sets[1])
    assert equal(first, keep)


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("n", [128, 4096, 352])
def test_decoders_replay_equal_eager(cuda, group, n):
    """Every invalid kind the benchmark sends is refused, on replay as
    eagerly; valid elsewhere (the identity included)."""
    fn = GROUPS[group].from_compressed_host
    sets = [(encodings(group, n, k, cuda),) for k in range(2)]
    want = [eager(fn, *s) for s in sets]
    for k, (_, valid) in enumerate(want):
        assert set(np.flatnonzero(~valid).tolist()) == invalid_lanes(n, k)
    check_replays(fn, sets, want)


def test_decoder_without_the_subgroup_check(cuda):
    """check_subgroup=False keys a graph of its own: the point outside the
    subgroup is then accepted."""
    data = encodings("g2", 128, 0, cuda)
    want = eager(g2.from_compressed_host, data, check_subgroup=False)
    for _ in range(3):
        got = g2.from_compressed_host(data, check_subgroup=False)
        assert same(got, want)
    assert want[1][OUTSIDE] and not want[1][X_TOO_LARGE]
    assert GRAPHS.snapshot() == counts(1, 2, 1)


def messages(n: int, k: int) -> np.ndarray:
    return np.random.default_rng(k).integers(0, 256, (n, 32), np.uint8)


@pytest.mark.parametrize("n", [128, 4096, 352])
def test_hash_to_g2_replays_equal_eager(cuda, n):
    sets = [(messages(n, k), DST) for k in range(2)]

    def fn(m, dst):
        return h2c.hash_to_curve_g2(m, dst, expand="device", device=cuda)

    want = [eager(fn, *s) for s in sets]
    check_replays(fn, sets, want)


@pytest.mark.parametrize("name", ["hash_to_curve_g1", "encode_to_curve_g1",
                                  "encode_to_curve_g2"])
@pytest.mark.parametrize("expand", ["device", "host"])
def test_the_other_hashes_replay_equal_eager(cuda, name, expand):
    sets = [([bytes(r) for r in messages(128, k)], DST) for k in range(2)]

    def fn(m, dst):
        if expand == "device":
            return getattr(h2c, name)(m, dst, expand="device", device=cuda)
        return getattr(h2c, name)(m, dst, device=cuda)

    want = [eager(fn, *s) for s in sets]
    check_replays(fn, sets, want)


def test_hashes_on_replay_give_the_kats(cuda):
    """The 20 KATs, one message a call (the device expander takes equal-
    length messages; the expanded bytes have one shape): each of the four
    functions eager at its first message, captured at its second, replayed
    after."""
    kats = json.loads(KATS.read_text())
    for name, dst in chip_smoke.KAT_DSTS.items():
        group = name[:2]
        kind = "hash" if name.endswith("ro") else "encode"
        fn = getattr(h2c, f"{kind}_to_curve_{group}")
        for c in kats[name]:
            out = fn([c["msg"].encode()], dst, expand="device", device=cuda)
            got = GROUPS[group].to_uncompressed_host(
                GROUPS[group].to_affine(out))
            assert bytes(got[0]).hex() == c["expected"], (name, c["msg"])
    total = sum(len(kats[k]) for k in chip_smoke.KAT_DSTS)
    assert GRAPHS.snapshot() == counts(4, total - 4, 4)


def pairing_launches(p, q) -> dict:
    LAUNCHES.reset()
    pairing(p, q)
    got = LAUNCHES.snapshot()
    del got["plan_exec_by_plan"]
    return got


def test_a_replayed_pairing_counts_the_expected_launches(cuda):
    p, q = pairing_set(256, 0, cuda)
    want = chip_smoke.expected_launches()
    runs = [pairing_launches(p, q) for _ in range(3)]
    assert GRAPHS.snapshot() == counts(1, 2, 1)
    assert runs == [want] * 3


def verify_call(b: int, k: int, dev, with_key: bool = True):
    """One call's public paths in the benchmark's call order: the keys' decode
    (not where the registry holds them), the signatures' decode, the hash
    to G2, one pairing over 2b lanes."""
    if with_key:
        g1.from_compressed_host(encodings("g1", b, k, dev))
    g2.from_compressed_host(encodings("g2", b, k, dev))
    h2c.hash_to_curve_g2(messages(b, k), DST, expand="device", device=dev)
    pairing(*pairing_set(2 * b, k, dev))


def test_the_stage_spans_of_a_replay_are_its_children(cuda):
    """A verify call at 128 sets with spans on, after two calls (eager,
    capture): each stage's top span holds its replay span, which holds the
    capture's stage spans, each within the replay's stream time.  The spans
    are turned on by `emit_nvtx`, not a CUPTI trace: a second CUPTI trace
    in one process can lose a kernel event, which the MSM graphs' profiler
    test counts."""
    for k in range(2):
        verify_call(128, k, cuda)
    profiling.clear()
    with torch.autograd.profiler.emit_nvtx():
        verify_call(128, 2, cuda)
        torch.cuda.synchronize()
    spans = profiling.spans()
    profiling.clear()
    assert GRAPHS.snapshot() == counts(4, 8, 4)
    by_id = {s["id"]: s for s in spans}
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s["parent"]].append(s)
    tops = [s for s in spans if s["parent"] not in by_id]
    assert [s["name"] for s in tops] == ["codec.decode", "codec.decode",
                                         "h2c", "pairing"]
    stages = {"codec.decode": ("codec.replay",
                               ["codec.sqrt", "codec.subgroup"]),
              "h2c": ("h2c.replay", ["h2c.map", "h2c.clear"]),
              "pairing": ("pairing.replay",
                          ["pairing.miller", "pairing.final_exp"])}
    for top in tops:
        replay_name, names = stages[top["name"]]
        (replay,) = [s for s in kids[top["id"]] if s["name"] == replay_name]
        below = kids[replay["id"]]
        assert [s["name"] for s in below] == names
        # the top span holds the eager steps around the body (the parse,
        # the XMD), the replay the body's steps between its stages
        assert top["launches"] >= replay["launches"] >= sum(
            s["launches"] for s in below) > 0
        assert all(0 < s["stream_ms"] <= replay["stream_ms"]
                   <= top["stream_ms"] for s in below)


@pytest.mark.parametrize("cell", ["block", "agg"])
def test_no_verify_graph_is_evicted_across_calls(cuda, cell):
    """Set-up's extra keys (the signing hash at every set's lanes; for the
    aggregate cell first the registry's 2^18-key decode, captured at its
    second chunk) fall out at the first call; the call's own graphs,
    captured at the second call, replay at every later one."""
    b = {"block": 128, "agg": 352}[cell]
    if cell == "agg":
        chunk = encodings("g1", 1 << 18, 0, cuda)
        for _ in range(3):
            g1.from_compressed_host(chunk)
        h2c.hash_to_curve_g2(messages(2 * b, 9), DST, expand="device",
                             device=cuda)
    else:
        h2c.hash_to_curve_g2(messages(8 * b, 9), DST, expand="device",
                             device=cuda)
    before = GRAPHS.snapshot()
    for k in range(5):
        verify_call(b, k, cuda, with_key=cell == "block")
    paths = 4 if cell == "block" else 3
    made = {name: GRAPHS.snapshot()[name] - before[name] for name in before}
    assert made == counts(paths, 4 * paths, paths)
    kept = [s for s in graphs._graphs.values()
            if isinstance(s, graphs._Graph)]
    assert len(kept) == paths and len(graphs._graphs) == graphs.SLOTS


def test_replays_on_two_streams_keep_their_order(cuda):
    """Pairings at one shape replayed from two streams, no wait between
    the callers: each value is its own inputs'."""
    sets = [pairing_set(256, k, cuda) for k in range(6)]
    want = [eager(pairing, *s) for s in sets]
    for _ in range(2):
        pairing(*sets[0])  # eager, then the capture
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    for i, s in enumerate(sets):
        with torch.cuda.stream(streams[i % 2]):
            got.append(pairing(*s))
    torch.cuda.synchronize()
    assert GRAPHS.snapshot() == counts(1, 1 + len(sets), 1)
    for i, (g, w) in enumerate(zip(got, want)):
        assert equal(g, w), f"call {i}"


def test_out_of_memory_in_the_pairing_drops_the_graphs(cuda):
    """With the 8,192-lane pairing's graph kept and half of a 4,096-lane
    pairing's peak free under a cap, the eager 4,096-lane call runs out of
    memory, drops the graph and runs once more; the 8,192-lane shape
    captures again at its next call."""
    big = pairing_set(8192, 0, cuda)
    for _ in range(2):
        pairing(*big)
    key = graphs._key(importlib.import_module(
        "bls12_381_torch.pairing.pairing")._pairing, big)
    assert isinstance(graphs._graphs[key], graphs._Graph)
    kept = graphs._graphs[key].nbytes  # no name may hold the graph
    small = pairing_set(4096, 0, cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    want = eager(pairing, *small)
    need = torch.cuda.max_memory_allocated() - held
    assert kept > need, (kept, need)
    spare = (need // 2) >> 21 << 21
    filler = fill_to_cap(cuda, spare)
    try:
        got = pairing(*small)
    finally:
        del filler
        torch.cuda.set_per_process_memory_fraction(1.0)
    assert equal(got, want)
    assert graphs._graphs[key] == graphs._SEEN
    assert equal(pairing(*big), eager(pairing, *big))
    assert GRAPHS.captures == 2 and GRAPHS.fallbacks == 0
