"""The cell `bls_aggverify_epoch` on the CPU: the readers of the key
aggregation's spans on synthetic spans; the driver `eth_aggregate_verify`
and its check at a tiny size (24 registry keys, two epochs of two blocks
of five sets), correct on a sound run; and not correct for the control
(the pairing comparison left out), for a pipeline that skips KeyValidate
of the sum, and for an aggregation that drops each set's last key."""

import numpy as np
import pytest

from bls12_381_torch.curves import g1

import control
import devtrace
import harness
import roofline
import stages
from conftest import make_root

MS = 1_000_000  # ns
TINY = {"agg_tiny": {
    "config": "eth_aggregate_verify", "traffic": "epoch_tiny",
    "why": "two epochs of two blocks of five sets on the CPU",
    "params": {"registry_keys": 24, "active_keys": 16, "slots_per_epoch": 2,
               "attestations": [3, 2], "sync_committee": 4,
               "sync_participants": 3, "epochs": 2, "block": 10,
               "reference_sample": 1, "warmup_calls": 0, "trace_calls": 1,
               "roofline": {"fp_products": 1}}}}


def reader(name):
    return harness.Bench().metric_reader(name)


def span(i, name, parent, start_ms, end_ms, stream_ms):
    return {"name": name, "id": i, "parent": parent,
            "start_ns": 10_000 * 10**9 + start_ms * MS,
            "end_ns": 10_000 * 10**9 + end_ms * MS,
            "launches": 0, "stream_ms": stream_ms}


def run(traced=True, calls=2, fp_products=11346720):
    trace = devtrace.Trace([], [], calls, 10_000.0, 10_001.0) \
        if traced else None
    return harness.Run(1.0, [], {"roofline": {"fp_products": fp_products}},
                       trace)


SPANS = [span(0, "agg", None, 10, 30, 18.0),
         span(1, "agg.gather", 0, 11, 13, 1.5),
         span(2, "agg.sum", 0, 13, 29, 14.0),
         span(3, "agg", None, 500, 520, 22.0),
         span(4, "agg.gather", 3, 501, 503, 2.5),
         span(5, "agg.sum", 3, 503, 519, 16.0)]


@pytest.mark.parametrize("name, want", [
    ("agg_gather_ms_per_call.agg", (1.5 + 2.5) / 2),
    ("agg_sum_ms_per_call.agg", (14.0 + 16.0) / 2),
    ("aggregate_roofline",
     100.0 * 11346720 * roofline.sop_imads(1) / roofline.IMAD_PER_S
     / 20e-3)])
def test_readers_on_synthetic_spans(monkeypatch, name, want):
    monkeypatch.setattr(stages, "program_spans", lambda: SPANS)
    assert reader(name)(run()) == pytest.approx(want)
    assert reader(name)(run(traced=False)) is None
    monkeypatch.setattr(stages, "program_spans", lambda: [])
    assert reader(name)(run()) is None


def test_roofline_reads_the_cells_work(monkeypatch):
    monkeypatch.setattr(stages, "program_spans", lambda: SPANS)
    read = reader("aggregate_roofline")
    assert read(run(fp_products=2 * 11346720)) == pytest.approx(
        2 * read(run()))
    # the least time of an epoch's 1,031,520 mixed additions: 0.40 ms
    assert read(run()) == pytest.approx(100 * 0.3988674 / 20.0, rel=1e-6)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"), TINY)


def prepared(root, control_run=False):
    bench = harness.Bench(root)
    mod = bench.driver_module("eth_aggregate_verify")
    driver = mod.Driver(bench.config("eth_aggregate_verify"),
                        bench.traffic("agg_tiny"), 2 ** 33 + 17, "cpu",
                        control=control_run)
    driver.setup()
    return mod, driver


def judge(mod, driver):
    calls, answers, _ = harness.window(driver, 0.0)
    checks, failed = mod.check(driver.reference_inputs(), answers,
                               driver.seed)
    assert len(calls) == driver.distinct_inputs == 2
    return all(v <= lim for v, lim in checks.values()), checks, failed


@pytest.fixture(scope="module")
def agg(root):
    return prepared(root)


def test_layout(agg):
    mod, driver = agg
    kinds = driver.kinds.reshape(2, 10)
    assert all(sorted(k) == [0] * 5 + [1, 2, 3, 4, 5] for k in kinds)
    ident = np.flatnonzero(driver.kinds == mod.IDENTITY_AGGREGATE)
    assert len(ident) == 2
    for i in ident:  # {pk, -pk}: a one-key set given its key's negation
        assert len(driver.set_keys[i]) == 2
        apk, filled = driver.registry.aggregate(driver.set_keys[i],
                                                [0, 2])
        assert bool(filled[0]) and bool(g1.is_identity(apk)[0])
    # sorted indices within a set, and each slot's attestations disjoint
    assert all((np.diff(s) > 0).all() for s in driver.set_keys)
    slot = np.concatenate(driver.set_keys[2:4])
    assert len(np.unique(slot)) == 5


def test_sound_run_is_correct(agg):
    correct, checks, failed = judge(*agg)
    assert correct and not failed, checks


def test_control_is_not_correct(root):
    out = control.control_run("agg_tiny", 5, 0.0, device="cpu", root=root)
    assert out["correct"] is False and out["attempted"] == 2
    assert out["checks"]["wrong_verdicts"]["value"] >= 1


@pytest.mark.parametrize("fault", ["no_key_validate", "dropped_key"])
def test_faults_are_not_correct(agg, fault, monkeypatch):
    mod, driver = agg
    verify = mod.verify_epoch
    if fault == "no_key_validate":
        def broken(*args, **kw):
            return verify(*args, key_validate=False, **kw)
    else:
        def broken(registry, indices, offsets, *args, **kw):
            keep = np.ones(len(indices), dtype=bool)
            keep[np.asarray(offsets[1:]) - 1] = False
            cut = np.asarray(offsets) - np.arange(len(offsets))
            return verify(registry, indices[keep], cut, *args, **kw)
    monkeypatch.setattr(mod, "verify_epoch", broken)
    correct, checks, failed = judge(mod, driver)
    assert not correct and failed, (fault, checks)
