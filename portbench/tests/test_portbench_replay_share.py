"""The reader `metrics/msm_replay_share.py` on synthetic spans: 0 where
every traced MSM ran eagerly, 1 where every one replayed (the replay
under an inner MSM of a chunked call counts for the outer), the share in
between, and None untraced, without spans or MSMs, or where the program
has no MSM graphs."""

import pytest

import devtrace
import harness

reader = harness.load_module(harness.Bench().dir / "metrics"
                             / "msm_replay_share.py",
                             "portbench_metric_msm_replay_share")
MS = 1_000_000  # ns


def span(i, name, parent, start_ms, end_ms, stream_ms=None):
    return {"name": name, "id": i, "parent": parent,
            "start_ns": 10_000 * 10**9 + start_ms * MS,
            "end_ns": 10_000 * 10**9 + end_ms * MS,
            "launches": 0, "stream_ms": stream_ms}


def traced_run(calls=2, start_s=10_000.0, end_s=10_001.0):
    return harness.Run(1.0, [], {},
                       devtrace.Trace([], [], calls, start_s, end_s))


def eager_call(i, start):
    return [span(i, "msm", None, start, start + 50, stream_ms=50.0),
            span(i + 1, "msm.recode", i, start, start + 10, stream_ms=9.0),
            span(i + 2, "msm.buckets", i, start + 10, start + 50,
                 stream_ms=39.0)]


def replayed_call(i, start, chunked=False):
    out = []
    top = i
    if chunked:
        out.append(span(i, "msm", None, start, start + 60, stream_ms=55.0))
        i += 1
    out += [span(i, "msm", None if not chunked else top, start, start + 50,
                 stream_ms=50.0),
            span(i + 1, "msm.replay", i, start, start + 50, stream_ms=49.0),
            span(i + 2, "msm.recode", i + 1, start, start + 50,
                 stream_ms=9.0)]
    return out


@pytest.fixture(autouse=True)
def graphs(monkeypatch):
    monkeypatch.setattr(reader, "has_graphs", lambda: True)


def test_every_call_eager_reads_0():
    spans = eager_call(0, 10) + eager_call(10, 100)
    assert reader.share(traced_run(), spans) == 0.0


def test_every_call_replayed_reads_1():
    spans = replayed_call(0, 10) + replayed_call(10, 100, chunked=True)
    assert reader.share(traced_run(), spans) == 1.0


def test_the_share_between():
    spans = (eager_call(0, 10) + replayed_call(10, 100)
             + replayed_call(20, 200) + eager_call(30, 300))
    assert reader.share(traced_run(), spans) == 0.5
    # a call before the window is not counted
    late = traced_run(start_s=10_000.15)
    assert reader.share(late, spans) == 0.5
    assert reader.share(traced_run(start_s=10_000.25), spans) == 0.0


def test_none(monkeypatch):
    spans = replayed_call(0, 10)
    assert reader.share(harness.Run(1.0, [], {}, None), spans) is None
    assert reader.share(traced_run(), []) is None
    assert reader.share(traced_run(), [span(0, "pairing", None, 10, 20)]) \
        is None
    monkeypatch.setattr(reader, "has_graphs", lambda: False)
    assert reader.share(traced_run(), spans) is None


def test_the_harness_reads_it(monkeypatch):
    """Both groups' names find the reader; it reads the program's spans."""
    monkeypatch.setattr(reader.stages, "program_spans",
                        lambda: replayed_call(0, 10))
    for name in ("msm_replay_share.msm", "msm_replay_share.blob"):
        read = harness.Bench().metric_reader(name)
        assert read(traced_run()) == (1.0 if reader.has_graphs() else None)
