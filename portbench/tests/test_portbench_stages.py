"""The readers of the program's own spans (`stages.py`) on synthetic
spans: outermost occurrences only, the traced window, the division by the
traced calls, and None untraced or where the program records no spans."""

import pytest

import devtrace
import harness
import stages

MS = 1_000_000  # ns


def span(i, name, parent, start_ms, end_ms, launches=0, stream_ms=None):
    return {"name": name, "id": i, "parent": parent,
            "start_ns": 10_000 * 10**9 + start_ms * MS,
            "end_ns": None if end_ms is None else
            10_000 * 10**9 + end_ms * MS,
            "launches": launches, "stream_ms": stream_ms}


def traced_run(calls=2, start_s=10_000.0, end_s=10_001.0):
    return harness.Run(1.0, [], {},
                       devtrace.Trace([], [], calls, start_s, end_s))


# two traced calls, each an MSM over two windows; the second call's MSM
# sits inside an outer MSM (a chunked call), which counts once; one span
# before the window, one still open
SPANS = [
    span(0, "msm", None, -50, -10, launches=99, stream_ms=40.0),
    span(1, "msm", None, 10, 110, launches=30, stream_ms=90.0),
    span(2, "msm.recode", 1, 10, 20, launches=4, stream_ms=9.0),
    span(3, "msm.buckets", 1, 20, 50, launches=10, stream_ms=28.0),
    span(4, "msm.window_sum", 1, 50, 60, launches=5, stream_ms=11.0),
    span(5, "msm.buckets", 1, 60, 90, launches=10, stream_ms=29.0),
    span(6, "msm.window_sum", 1, 90, 110, launches=5, stream_ms=12.0),
    span(7, "msm", None, 200, 320, launches=40, stream_ms=110.0),
    span(8, "msm", 7, 200, 300, launches=30, stream_ms=95.0),
    span(9, "msm.buckets", 8, 210, 260, launches=20, stream_ms=50.0),
    span(10, "msm", None, 900, None, stream_ms=None),
]


def test_outermost_occurrences_only():
    run = traced_run()
    # 90 + 110: the inner MSM of the second call is not added again
    assert stages.ms_per_call(run, "msm", SPANS) == pytest.approx(100.0)
    assert stages.ms_per_call(run, "msm.buckets", SPANS) == \
        pytest.approx((28.0 + 29.0 + 50.0) / 2)
    assert [s["id"] for s in stages.outermost(SPANS, "msm")] == [0, 1, 7,
                                                                10]


def test_a_name_nested_in_itself_through_other_spans():
    spans = [span(0, "a", None, 0, 10, stream_ms=10.0),
             span(1, "b", 0, 1, 9, stream_ms=8.0),
             span(2, "a", 1, 2, 8, stream_ms=6.0)]
    assert [s["id"] for s in stages.outermost(spans, "a")] == [0]
    assert [s["id"] for s in stages.outermost(spans, "b")] == [1]


def test_the_window_filter():
    run = traced_run()
    window = stages.in_window(SPANS, run.trace)
    # before the window and the open span are left out
    assert [s["id"] for s in window] == list(range(1, 10))
    narrow = traced_run(start_s=10_000.1)
    assert stages.ms_per_call(narrow, "msm", SPANS) == pytest.approx(55.0)


def test_the_division_by_calls():
    one, four = traced_run(calls=1), traced_run(calls=4)
    assert stages.ms_per_call(one, "msm.recode", SPANS) == 9.0
    assert stages.ms_per_call(four, "msm.recode", SPANS) == 9.0 / 4


def test_port_launches_over_the_top_level_spans():
    # top level in the window: spans 1 and 7 (30 + 40), not their stages
    assert stages.port_launches_per_call(traced_run(), SPANS) == 35.0
    # a span whose parent lies outside the window is top level in it
    run = traced_run(start_s=10_000.205)
    assert stages.port_launches_per_call(run, SPANS) == 20 / 2


def test_host_time_off_the_card():
    spans = [span(0, "pairing", None, 0, 30),
             span(1, "pairing.final_exp", 0, 10, 30)]
    run = traced_run(calls=1)
    assert stages.ms_per_call(run, "pairing.final_exp", spans) == \
        pytest.approx(20.0)


def test_none_untraced_or_without_spans(monkeypatch):
    untraced = harness.Run(1.0, [], {}, None)
    assert stages.ms_per_call(untraced, "msm", SPANS) is None
    assert stages.port_launches_per_call(untraced, SPANS) is None
    run = traced_run()
    assert stages.ms_per_call(run, "msm", []) is None
    assert stages.ms_per_call(run, "pairing", SPANS) is None
    assert stages.port_launches_per_call(run, []) is None
    late = traced_run(start_s=10_002.0, end_s=10_003.0)
    assert stages.port_launches_per_call(late, SPANS) is None
    # a program with no span recorder (an older commit)
    monkeypatch.setattr(stages, "program_spans", lambda: None)
    assert stages.ms_per_call(run, "msm") is None
    assert stages.port_launches_per_call(run) is None


@pytest.mark.parametrize("name", [
    "port_launches_per_call.msm", "msm_recode_ms_per_call.blob",
    "msm_buckets_ms_per_call.msm", "msm_window_sum_ms_per_call.blob",
    "codec_sqrt_ms_per_call.verify", "subgroup_check_ms_per_call.block",
    "h2c_map_ms_per_call.verify", "h2c_clear_ms_per_call.block",
    "miller_ms_per_call.verify", "final_exp_ms_per_call.block"])
def test_readers_read_the_program(name, monkeypatch):
    spans = [span(0, "msm", None, 0, 50, launches=7, stream_ms=50.0),
             span(1, "msm.recode", 0, 0, 10, stream_ms=10.0),
             span(2, "msm.buckets", 0, 10, 30, stream_ms=20.0),
             span(3, "msm.window_sum", 0, 30, 50, stream_ms=20.0),
             span(4, "pairing", None, 60, 100, launches=3, stream_ms=40.0),
             span(5, "codec.sqrt", 4, 60, 61, stream_ms=1.0),
             span(6, "codec.subgroup", 4, 61, 62, stream_ms=1.0),
             span(7, "h2c.map", 4, 62, 63, stream_ms=1.0),
             span(8, "h2c.clear", 4, 63, 64, stream_ms=1.0),
             span(9, "pairing.miller", 4, 64, 80, stream_ms=16.0),
             span(10, "pairing.final_exp", 4, 80, 100, stream_ms=20.0)]
    monkeypatch.setattr(stages, "program_spans", lambda: spans)
    reader = harness.Bench().metric_reader(name)
    assert reader(traced_run(calls=1)) is not None
    assert reader(harness.Run(1.0, [], {}, None)) is None
    if name.startswith("port_launches"):
        assert reader(traced_run(calls=1)) == 10
