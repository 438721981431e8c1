"""The MSM's CUDA graphs (`utils/graphs.py`, `graphed`) and their span
templates (`utils/profiling.py`, `capturing` / `replaying`), on the CPU.

A capture needs a card (`test_torch_msm_graph_gpu.py` replays there); here
CPU tensors must never capture, the shape key must part what fixes the
launch sequence, a template's spans, emitted after a replay, must repeat
an eager call's, and the graphs' budget must hold: the shapes kept, the
bytes kept, and their release where a public path runs out of memory.  The group law, the recode and the bucket steps
are stubbed with counted no-ops (a real MSM takes ~10 s on this CPU), so
the window loop and the spans around it are the module's own.

Tolerance: none -- spans compare by name, nesting and launch count.
"""

import collections
import types
import weakref

import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from bls12_381_torch.kernels import GRAPHS, LaunchCounts
from bls12_381_torch.ops import msm
from bls12_381_torch.utils import graphs, profiling

WINDOWS, C = 3, 4


class FakeEvent:
    """torch.cuda.Event on the CPU: counts what is made and recorded."""
    made = 0

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing
        FakeEvent.made += 1
        self.external = external
        self.recorded = 0

    def record(self, stream=None):
        self.recorded += 1

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        assert self.recorded == end.recorded == 1
        return 0.25


class CountedCurve:
    """The group law as no-ops, each counted as one plan launch."""

    def __init__(self, counts):
        self.counts = counts

    def identity(self, batch=(), device="cpu"):
        return tuple(torch.zeros((24,) + tuple(batch), dtype=torch.int32)
                     for _ in range(3))

    def add(self, a, b):
        self.counts.plan_exec += 1
        return a

    def double(self, a):
        self.counts.plan_exec += 1
        return a


@pytest.fixture
def stubbed(monkeypatch):
    """msm_g1 with counted stubs for its arithmetic, the fake card's
    events, and a LaunchCounts of its own; yields the counts."""
    counts = LaunchCounts()
    FakeEvent.made = 0
    monkeypatch.setattr(profiling, "LAUNCHES", counts)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(msm, "G1", types.SimpleNamespace(
        CURVE=CountedCurve(counts)))

    def recode(points, scalars, c, glv):
        counts.sop_fr += 1
        mags = torch.arange(WINDOWS * 4, dtype=torch.int32).reshape(
            WINDOWS, 4) % 3
        return None, mags, mags == 1

    def buckets(curve_mod, aff, order, mags_s, negs_s, c):
        counts.plan_exec += 5
        return None

    monkeypatch.setattr(msm, "_recode_g1", recode)
    monkeypatch.setattr(msm, "_window_buckets", buckets)
    monkeypatch.setattr(msm, "_bucket_sum",
                        lambda curve, b, dev: curve.identity())
    monkeypatch.setattr(graphs, "_graphs", collections.OrderedDict())
    profiling.clear()
    yield counts
    profiling.clear()


def inputs(n=4):
    pts = tuple(torch.zeros((24, n), dtype=torch.int32) for _ in range(3))
    return pts, torch.zeros((16, n), dtype=torch.int32)


def tree(spans, root):
    """(name, launches, children) of the span `root` and those below."""
    kids = collections.defaultdict(list)
    for s in spans:
        kids[s["parent"]].append(s)
    return (root["name"], root["launches"],
            [tree(spans, k) for k in kids[root["id"]]])


def test_cpu_inputs_never_capture(stubbed):
    """msm_g1 on CPU tensors with the card's events faked (as
    test_torch_spans fakes them): three calls at one shape, eager each,
    GRAPHS untouched, no shape remembered."""
    before = GRAPHS.snapshot()
    pts, k = inputs()
    for _ in range(3):
        msm.msm_g1(pts, k, C)
    assert GRAPHS.snapshot() == before
    assert not graphs._graphs
    assert stubbed.sop_fr == 3
    assert FakeEvent.made == 0  # no profiler, no capture: no span


def test_emitted_template_repeats_the_eager_spans(stubbed):
    pts, k = inputs()
    with autograd_profiler.emit_itt():
        msm.msm_g1(pts, k, C)
    eager = profiling.spans()
    profiling.clear()
    made_eager = FakeEvent.made

    with profiling.capturing() as cap:
        msm._msm_g1(pts, k, C, True)
    # every span of the capture recorded, no profiler active: two external
    # events each, recorded once
    assert len(cap.spans) == 1 + 2 * WINDOWS == len(eager) - 1
    events = [e for *_, pair in cap.spans for e in pair]
    assert len(events) == FakeEvent.made - made_eager
    assert all(e.external and e.recorded == 1 for e in events)

    with autograd_profiler.emit_itt():
        with profiling.span("msm"):
            with profiling.replaying("msm.replay", cap):
                pass
    replayed = profiling.spans()
    (top,) = [s for s in replayed if s["parent"] is None]
    (replay,) = [s for s in replayed if s["parent"] == top["id"]]
    assert replay["name"] == "msm.replay"
    (eager_top,) = [s for s in eager if s["parent"] is None]
    # below msm.replay, the eager call's stages: names, order, nesting and
    # launches (1 recode; per window 5 bucket and C + 1 sum launches)
    name, launches, stages = tree(replayed, replay)
    assert stages == tree(eager, eager_top)[2]
    assert [s[1] for s in stages] == [1] + [5, C + 1] * WINDOWS
    assert all(s["stream_ms"] == 0.25 for s in replayed)
    # stamped inside the replay, ids after it
    for s in replayed:
        if s["parent"] == replay["id"]:
            assert replay["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= replay["end_ns"]
            assert s["id"] > replay["id"]


def test_no_profiler_no_emitted_span(stubbed):
    pts, k = inputs()
    with profiling.capturing() as cap:
        msm._msm_g1(pts, k, C, True)
    with profiling.replaying("msm.replay", cap):
        pass
    assert profiling.spans() == []


def test_emitted_spans_are_bounded(stubbed, monkeypatch):
    """Past MAX_SPANS the template's spans are dropped and counted, as an
    eager call's are."""
    pts, k = inputs()
    with profiling.capturing() as cap:
        msm._msm_g1(pts, k, C, True)
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with autograd_profiler.emit_itt():
        with profiling.span("msm"):
            with profiling.replaying("msm.replay", cap):
                pass
    names = [s["name"] for s in profiling.spans()]
    assert names == ["msm", "msm.replay", "msm.recode"]
    assert profiling.dropped() == 2 * WINDOWS


def test_the_key_parts_group_n_window_and_split():
    pts, k = inputs(8)
    g1, g2 = msm._msm_g1, msm._msm_g2
    base = graphs._key(g1, (pts, k), 12, True)
    assert base == graphs._key(g1, inputs(8), 12, True)
    others = [graphs._key(g2, (pts, k), 12, True),
              graphs._key(g1, inputs(16), 12, True),
              graphs._key(g1, (pts, k), 13, True),
              graphs._key(g1, (pts, k), 12, False),
              graphs._key(g1, (pts, k.long()), 12, True)]
    assert len({base, *others}) == 1 + len(others)


def test_least_recently_used_shapes_go(monkeypatch):
    monkeypatch.setattr(graphs, "_graphs", collections.OrderedDict())
    assert graphs.SLOTS == 4
    for key in range(4):
        graphs._remember(key, graphs._SEEN)
    graphs._remember(0, graphs._EAGER)  # used again: the newest
    graphs._remember("fifth", graphs._SEEN)
    assert list(graphs._graphs) == [2, 3, 0, "fifth"]
    assert graphs._graphs[0] == graphs._EAGER


def fake_graph(nbytes=0, device=0):
    return graphs._Graph(None, None, None, None, None, nbytes, device)


def test_kept_graphs_stay_within_their_bytes(monkeypatch):
    """A new graph drops the least recently used graphs of its card until
    the bytes kept fit the budget; other cards' graphs and shapes without
    a graph stay."""
    monkeypatch.setattr(graphs, "_graphs", collections.OrderedDict())
    monkeypatch.setattr(graphs, "_budget", lambda device: 100)
    graphs._remember("a", fake_graph(40))
    graphs._remember("b", fake_graph(40))
    graphs._remember("other card", fake_graph(90, device=1))
    graphs._remember("seen", graphs._SEEN)
    assert len(graphs._graphs) == 4
    graphs._remember("c", fake_graph(50))
    assert list(graphs._graphs) == ["b", "other card", "seen", "c"]
    graphs._remember("b", graphs._graphs["b"])  # used again: the newest
    # a fifth shape: the oldest (the other card's) goes, then c for bytes
    graphs._remember("d", fake_graph(60))
    assert list(graphs._graphs) == ["seen", "b", "d"]


def test_out_of_memory_drops_the_graphs_and_runs_once_more(monkeypatch):
    """The graphs' pools are a cache: an eager call or a capture that runs
    out of device memory while graphs are kept drops them (their shapes
    capture again) and runs once more, its failed attempt's launches taken
    back; with no graph kept the error stands."""
    counts = LaunchCounts()
    monkeypatch.setattr(graphs, "LAUNCHES", counts)
    monkeypatch.setattr(graphs, "_graphs", collections.OrderedDict())
    graphs._remember("a", fake_graph())
    graphs._remember("b", graphs._EAGER)
    attempts = []

    def call():
        counts.plan_exec += 3
        attempts.append(len(attempts))
        if len(attempts) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return "point"

    assert graphs._or_release(call) == "point"
    assert attempts == [0, 1] and counts.plan_exec == 3
    assert dict(graphs._graphs) == {"a": graphs._SEEN, "b": graphs._EAGER}
    attempts.clear()
    with pytest.raises(torch.OutOfMemoryError):
        graphs._or_release(call)
    assert attempts == [0]


def test_release_lets_go_of_every_graph_before_emptying_the_cache(
        monkeypatch):
    """A pool is given back only once nothing holds its graph: at
    `empty_cache` no dropped graph may be alive, the newest included."""
    monkeypatch.setattr(graphs, "_graphs", collections.OrderedDict())
    monkeypatch.setattr(graphs, "_budget", lambda device: 100)
    refs = []
    for key in ("a", "b"):
        g = fake_graph()
        refs.append(weakref.ref(g))
        graphs._remember(key, g)
    del g
    alive = []
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: alive.extend(r() for r in refs))
    graphs.release()
    assert alive == [None, None]
    assert dict(graphs._graphs) == {"a": graphs._SEEN, "b": graphs._SEEN}


def test_every_public_path_releases_the_graphs(monkeypatch):
    """The paths `entry` names, beyond the MSM (which releases in
    `graphed`), release the graphs where they run out of memory: an NTT
    that runs out once with a graph kept runs once more, with the same
    answer."""
    from bls12_381_torch import entry
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.hash_to_curve import h2c
    from bls12_381_torch.ops import ntt
    from bls12_381_torch.pairing import gt
    from bls12_381_torch.pairing.pairing import pairing

    paths = [pairing, ntt.ntt, ntt.intt, ntt.poly_mul,
             g1.scalar_mul, g2.scalar_mul, gt.scalar_mul,
             g1.from_compressed_host, g1.from_uncompressed_host,
             g2.from_compressed_host, g2.from_uncompressed_host,
             h2c.hash_to_curve_g1, h2c.encode_to_curve_g1,
             h2c.hash_to_curve_g2, h2c.encode_to_curve_g2]
    assert all(getattr(fn, "releases_graphs", False) for fn in paths)

    coeffs = entry.ntt_inputs(3, device="cpu")
    want = ntt.ntt(coeffs)
    monkeypatch.setattr(graphs, "_graphs", collections.OrderedDict())
    graphs._remember("a", fake_graph())
    runs = []
    real = ntt.fr.butterfly

    def butterfly(a, b, tw):
        runs.append(1)
        if len(runs) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return real(a, b, tw)

    monkeypatch.setattr(ntt.fr, "butterfly", butterfly)
    assert torch.equal(ntt.ntt(coeffs), want)
    assert len(runs) == 1 + 3 and graphs._graphs["a"] == graphs._SEEN


def test_launch_counts_since_add_restore():
    counts = LaunchCounts()
    counts.sop = 2
    counts.plan_exec_by_plan["g1_add"] += 1
    before = counts.snapshot()
    counts.plan_exec += 3
    counts.plan_exec_by_plan["g1_add"] += 2
    counts.plan_exec_by_plan["g1_double"] += 1
    counts.copied_rows += 1
    made = counts.since(before)
    assert made["plan_exec"] == 3 and made["sop"] == 0
    assert made["plan_exec_by_plan"] == {"g1_add": 2, "g1_double": 1}
    assert made["copied_rows"] == 1
    counts.restore(before)
    assert counts.snapshot() == before
    counts.add(made)
    counts.add(made)
    assert counts.plan_exec == 6 and counts.port_total() == 8
    assert counts.plan_exec_by_plan == {"g1_add": 5, "g1_double": 2}
