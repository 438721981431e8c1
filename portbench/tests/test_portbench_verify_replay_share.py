"""The reader `metrics/verify_replay_share.py` on synthetic spans: 1 where
every traced verify stage (`codec.decode`, `h2c`, `pairing`) replayed, 0
where every one ran eagerly, the share in between (each stage counted
once, a replay counting only for its own stage), and None untraced,
without spans or verify stages, or where the program has no graphs."""

import pytest

import devtrace
import harness

reader = harness.load_module(harness.Bench().dir / "metrics"
                             / "verify_replay_share.py",
                             "portbench_metric_verify_replay_share")
MS = 1_000_000  # ns
STAGES = {"codec.decode": ("codec.replay", ["codec.sqrt", "codec.subgroup"]),
          "h2c": ("h2c.replay", ["h2c.map", "h2c.clear"]),
          "pairing": ("pairing.replay",
                      ["pairing.miller", "pairing.final_exp"])}


def span(i, name, parent, start_ms, end_ms, stream_ms=1.0):
    return {"name": name, "id": i, "parent": parent,
            "start_ns": 10_000 * 10**9 + start_ms * MS,
            "end_ns": 10_000 * 10**9 + end_ms * MS,
            "launches": 0, "stream_ms": stream_ms}


def traced_run(calls=2, start_s=10_000.0, end_s=10_001.0):
    return harness.Run(1.0, [], {},
                       devtrace.Trace([], [], calls, start_s, end_s))


def stage(i, name, start, replayed):
    """One outermost stage span at `start` ms: its stage spans below it,
    under its replay span where it replayed.  Returns (spans, next id)."""
    replay, kids = STAGES[name]
    out = [span(i, name, None, start, start + 10)]
    parent, j = i, i + 1
    if replayed:
        out.append(span(j, replay, i, start, start + 10))
        parent, j = j, j + 1
    for k in kids:
        out.append(span(j, k, parent, start, start + 5))
        j += 1
    return out, j


def call(i, start, replayed=(True, True, True, True),
         names=("codec.decode", "codec.decode", "h2c", "pairing")):
    """A verify call's program spans: the two decodes, the hash, the
    pairing, each replayed or not."""
    out = []
    for k, (name, r) in enumerate(zip(names, replayed)):
        spans, i = stage(i, name, start + 10 * k, r)
        out += spans
    return out, i


@pytest.fixture(autouse=True)
def graphs(monkeypatch):
    monkeypatch.setattr(reader, "has_graphs", lambda: True)


def test_every_stage_replayed_reads_1():
    a, i = call(0, 10)
    b, _ = call(i, 100)
    assert reader.share(traced_run(), a + b) == 1.0


def test_every_stage_eager_reads_0():
    a, i = call(0, 10, replayed=(False,) * 4)
    b, _ = call(i, 100, replayed=(False,) * 4)
    assert reader.share(traced_run(), a + b) == 0.0


def test_mixed_calls_read_the_share():
    """A call whose pairing ran eagerly, and an aggregate call (no key
    decode; an `agg` span, which is not a verify stage)."""
    a, i = call(0, 10, replayed=(True, True, True, False))
    b, i = call(i, 100, replayed=(True, True, False),
                names=("codec.decode", "h2c", "pairing"))
    agg = [span(i, "agg", None, 90, 99), span(i + 1, "agg.sum", i, 90, 99)]
    assert reader.share(traced_run(), a + b + agg) == 5 / 7
    # a call before the window is not counted
    assert reader.share(traced_run(start_s=10_000.095), a + b + agg) == 2 / 3


def test_a_replay_counts_for_its_own_stage_only():
    """A pairing span holding a decode's replay span (no such program
    exists) is not a replayed pairing."""
    spans = [span(0, "pairing", None, 10, 20),
             span(1, "codec.replay", 0, 10, 20)]
    assert reader.share(traced_run(), spans) == 0.0


def test_none(monkeypatch):
    spans, _ = call(0, 10)
    assert reader.share(harness.Run(1.0, [], {}, None), spans) is None
    assert reader.share(traced_run(), []) is None
    assert reader.share(traced_run(), [span(0, "msm", None, 10, 20),
                                       span(1, "msm.replay", 0, 10, 20)]) \
        is None
    assert reader.share(traced_run(start_s=10_001.5, end_s=10_002.0),
                        spans) is None
    monkeypatch.setattr(reader, "has_graphs", lambda: False)
    assert reader.share(traced_run(), spans) is None


def test_the_harness_reads_it(monkeypatch):
    """The three groups' names find the reader; it reads the program's
    spans."""
    monkeypatch.setattr(reader.stages, "program_spans",
                        lambda: call(0, 10)[0])
    for name in ("verify_replay_share.block", "verify_replay_share.verify",
                 "verify_replay_share.agg"):
        read = harness.Bench().metric_reader(name)
        assert read(traced_run()) == (1.0 if reader.has_graphs() else None)
