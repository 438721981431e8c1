"""The port's own spans (`utils/profiling.py`) and its launch total
(`kernels.LAUNCHES.port_total()`) on the CPU.

Spans record exactly while a torch.profiler session is active in the
process.  The paths run under `torch.autograd.profiler.emit_itt()`, the
session that records the least per operator (a batch-2 pairing under
`torch.profiler.profile(activities=[CPU])` takes ~45 s on a Xeon CPU,
three times as long); the profiler proper records spans too
(`test_trace_*`).  On the CPU a span has no CUDA events; `fake_card`
stands in for the card's, so that the tests see every event a span would
make there.

Tolerance: none -- spans compare by name, id and time, results bit for bit.
"""

import json
import sys
import threading
from collections import Counter

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from bls12_381_torch import entry, pairing
from bls12_381_torch.kernels import LaunchCounts
from bls12_381_torch.limbs import FR
from bls12_381_torch import limbs
from bls12_381_torch.ops import msm
from bls12_381_torch.utils import profiling

torch.set_num_threads(1)
MSM_WINDOW = 4


class FakeEvent:
    """torch.cuda.Event on the CPU: counts what is made and recorded."""
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.recorded = 0

    def record(self, stream=None):
        self.recorded += 1

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        assert self.recorded == end.recorded == 1
        return 0.25


@pytest.fixture
def fake_card(monkeypatch):
    FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    profiling.clear()
    yield FakeEvent
    profiling.clear()


def children(spans):
    """Each span's children's names, in order, by the span's id."""
    kids = {s["id"]: [] for s in spans}
    for s in spans:
        if s["parent"] is not None:
            kids[s["parent"]].append(s["name"])
    return kids


def assert_nested(spans):
    """Each span lies inside its parent in time, and ids grow with
    start."""
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["id"] < s["id"]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= \
                p["end_ns"]
    starts = [s["start_ns"] for s in spans]
    assert starts == sorted(starts)


@pytest.fixture(scope="module")
def msm_runs():
    """An 8-point msm_g1 at c = 4, with the profiler off and under a
    session, each with the fake card's events counted: (result off,
    spans off, events off, result on, spans on, events on)."""
    pts, k = entry.msm_inputs(3, "g1", device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.cuda, "is_initialized", lambda: True)
    mp.setattr(torch.cuda, "Event", FakeEvent)
    try:
        profiling.clear()
        FakeEvent.made = 0
        off = msm.msm_g1(pts, k, MSM_WINDOW)
        off_spans, off_events = profiling.spans(), FakeEvent.made
        with autograd_profiler.emit_itt():
            on = msm.msm_g1(pts, k, MSM_WINDOW)
        on_spans, on_events = profiling.spans(), FakeEvent.made
    finally:
        mp.undo()
        profiling.clear()
    return off, off_spans, off_events, on, on_spans, on_events


def test_no_profiler_no_span_no_event(msm_runs):
    off, off_spans, off_events = msm_runs[:3]
    assert not autograd_profiler._is_profiler_enabled
    assert off_spans == [] and off_events == 0
    # the off span is one shared object: nothing is made per call
    assert profiling.span("a") is profiling.span("b")


def test_msm_spans(msm_runs):
    on_spans, on_events = msm_runs[4:]
    windows = limbs.signed_digits_lsb(torch.zeros((FR.n_limbs, 1),
                                                  dtype=torch.int32),
                                      128, MSM_WINDOW)[0].shape[0]
    names = Counter(s["name"] for s in on_spans)
    assert names == {"msm": 1, "msm.recode": 1, "msm.buckets": windows,
                     "msm.window_sum": windows}
    kids = children(on_spans)
    (top,) = [s for s in on_spans if s["parent"] is None]
    assert top["name"] == "msm"
    assert kids[top["id"]] == ["msm.recode"] + \
        ["msm.buckets", "msm.window_sum"] * windows
    assert_nested(on_spans)
    # two events a span, each read once; the plain versions launch nothing
    assert on_events == 2 * len(on_spans)
    assert all(s["stream_ms"] == 0.25 for s in on_spans)
    assert all(s["launches"] == 0 for s in on_spans)


def test_msm_result_unchanged_by_spans(msm_runs):
    off, on = msm_runs[0], msm_runs[3]
    assert all(torch.equal(a, b) for a, b in zip(off, on))


def test_pairing_spans():
    """A batch-2 pairing: `pairing` > `pairing.miller`,
    `pairing.final_exp`, nested by id and by time, on the host clock."""
    p, q = entry.tiny_pairing_inputs(2, "cpu")
    profiling.clear()
    try:
        with autograd_profiler.emit_itt():
            pairing.pairing(p, q)
        spans = profiling.spans()
    finally:
        profiling.clear()
    assert [s["name"] for s in spans] == ["pairing", "pairing.miller",
                                          "pairing.final_exp"]
    top, miller, fexp = spans
    assert top["parent"] is None
    assert miller["parent"] == fexp["parent"] == top["id"]
    assert top["id"] < miller["id"] < fexp["id"]
    assert miller["end_ns"] <= fexp["start_ns"]
    assert_nested(spans)
    assert all(s["stream_ms"] is None for s in spans)


def test_trace_writes_program_spans(tmp_path, fake_card, monkeypatch):
    counts = LaunchCounts()
    monkeypatch.setattr(profiling, "LAUNCHES", counts)
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer"):
            torch.ones(4).sum()
            with profiling.span("inner"):
                counts.plan_exec += 3
    with profiling.span("after"):
        pass
    data = json.loads((tmp_path / profiling.SPANS_FILE).read_text())
    assert data["dropped"] == 0
    outer, inner = data["spans"]
    assert (outer["name"], inner["name"]) == ("outer", "inner")
    assert inner["parent"] == outer["id"] and outer["parent"] is None
    assert outer["launches"] == inner["launches"] == 3
    assert outer["stream_ms"] == inner["stream_ms"] == 0.25
    assert set(outer) == {"name", "id", "parent", "start_ns", "end_ns",
                          "launches", "stream_ms"}
    assert fake_card.made == 4
    # the torch trace beside it
    assert len(list(tmp_path.glob("*.json"))) == 2


def test_trace_records_under_the_profiler_alone(fake_card):
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled
        with profiling.span("a"):
            pass
    with profiling.span("b"):
        pass
    assert [s["name"] for s in profiling.spans()] == ["a"]


def test_bounded_with_a_dropped_count(fake_card, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("kept"):
            for _ in range(4):
                with profiling.span("inner"):
                    pass
    assert [s["name"] for s in profiling.spans()] == ["kept", "inner",
                                                      "inner"]
    assert profiling.dropped() == 2
    assert fake_card.made == 6
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_an_open_span_and_an_exception(fake_card):
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with profiling.span("raises"):
                raise ValueError
        with profiling.span("open"):
            (raised, still_open) = profiling.spans()
    assert raised["end_ns"] is not None and raised["stream_ms"] == 0.25
    assert still_open["end_ns"] is None and still_open["launches"] is None
    assert still_open["parent"] is None


def test_each_thread_has_its_own_stack(fake_card):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("main"):
            t = threading.Thread(target=lambda: profiling.span("other")
                                 .__enter__().__exit__(None, None, None))
            t.start()
            t.join()
    main, other = profiling.spans()
    assert other["parent"] is None and main["parent"] is None


def test_threads_record_every_span(fake_card):
    """More threads than cores, a short switch interval: no span is lost
    and each thread's spans nest in its own stack."""
    threads, per_thread = 16, 100

    def work():
        for _ in range(per_thread):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    spans = profiling.spans()
    assert len(spans) == 2 * threads * per_thread
    assert len({s["id"] for s in spans}) == len(spans)
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"] == "inner":
            assert by_id[s["parent"]]["name"] == "outer"
        else:
            assert s["parent"] is None
    assert profiling.dropped() == 0


def test_spanned_decorator(fake_card):
    @profiling.spanned("f")
    def f(x, y=2):
        """doc"""
        return x + y

    assert f.__name__ == "f" and f.__doc__ == "doc"
    assert f(1) == 3 and profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert f(1, y=5) == 6
    assert [s["name"] for s in profiling.spans()] == ["f"]


def test_port_total_and_derived_reset_snapshot():
    counts = LaunchCounts()
    counts.sop = 1
    counts.plan_exec = 4
    counts.plan_exec_by_plan["g1_add"] += 4
    counts.pow_fixed = 2
    counts.shake = 1
    counts.copied_rows = 7
    assert counts.port_total() == 8
    snap = counts.snapshot()
    assert list(snap) == ["sop", "sqr", "plan_exec", "sop_fr", "butterfly",
                          "fold_planned", "pow_fixed", "pow_fixed_fr",
                          "fp2_pow_fixed", "sha256", "xmd_sha256", "shake",
                          "copied_rows", "plan_exec_by_plan"]
    assert snap["plan_exec_by_plan"] == {"g1_add": 4}
    assert type(snap["plan_exec_by_plan"]) is dict
    assert snap["copied_rows"] == 7
    counts.reset()
    assert counts.port_total() == 0
    assert all(v == 0 for k, v in counts.snapshot().items()
               if k != "plan_exec_by_plan")
    assert counts.snapshot()["plan_exec_by_plan"] == {}
    # every int field but copied_rows is a launch count
    for name in [k for k in snap if k not in ("copied_rows",
                                               "plan_exec_by_plan")]:
        setattr(counts, name, 1)
    assert counts.port_total() == 12
