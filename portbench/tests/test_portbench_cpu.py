"""Each driver and the plain reference agree end to end on the CPU at tiny
sizes (the program's plain PyTorch path): 8 MSM points, 5 verify sets, one
honest and one of each kind of invalid set.  The controls, and the timed
path broken underneath in each way these cells can break (half of the
batch left out, an answer altered where it is produced, a state returned
unchanged, the identity key let through), come out not correct.  The cells have one chip, so there is no exchange between
chips to leave out."""

import functools
import os
from pathlib import Path

import numpy as np
import pytest

import control
import harness
from conftest import TINY, make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


def prepared(root, cell, control_run=False, device="cpu", **driver_kw):
    bench = harness.Bench(root)
    w = bench.workload(cell)
    mod = bench.driver_module(w["config"])
    driver = mod.Driver(bench.config(w["config"]), bench.traffic(cell),
                        2 ** 33 + 17, device, control=control_run,
                        **driver_kw)
    driver.setup()
    return mod, driver


def judge(mod, driver):
    """The window (each distinct input once) and the check; correct?"""
    calls, answers, _ = harness.window(driver, 0.0)
    checks, failed = mod.check(driver.reference_inputs(), answers,
                               driver.seed)
    assert len(calls) == driver.distinct_inputs
    return all(v <= lim for v, lim in checks.values()), checks, failed


@pytest.fixture(scope="module")
def msm(root):
    # window 4 keeps the plain path's commitments to seconds on the CPU
    return prepared(root, "msm_tiny", window_bits=4)


@pytest.fixture(scope="module")
def verify(root):
    return prepared(root, "verify_tiny")


def test_msm_agrees(msm):
    correct, checks, failed = judge(*msm)
    assert correct and not failed, checks


def test_msm_control(root):
    correct, checks, _ = judge(*prepared(root, "msm_tiny", control_run=True,
                                         window_bits=4))
    assert not correct and checks["wrong_commitments"][0] >= 1


def msm_fault(kind, entry):
    from bls12_381_torch.curves import g1

    if kind == "half_batch":
        def broken(points, scalars, **kw):
            half = scalars.shape[-1] // 2
            return entry(tuple(t[..., :half] for t in points),
                         scalars[..., :half], **kw)
    elif kind == "altered":
        def broken(points, scalars, **kw):
            return g1.double(entry(points, scalars, **kw))
    else:  # the first answer returned for every call
        first = []

        def broken(points, scalars, **kw):
            if not first:
                first.append(entry(points, scalars, **kw))
            return first[0]
    return broken


@pytest.mark.parametrize("kind", ["half_batch", "altered", "unchanged"])
def test_msm_faults(msm, kind):
    mod, driver = msm
    entry = driver.entry
    driver.entry = msm_fault(kind, entry)
    try:
        correct, checks, failed = judge(mod, driver)
    finally:
        driver.entry = entry
    assert not correct and failed, (kind, checks)


def test_verify_agrees(verify):
    mod, driver = verify
    kinds = driver.kinds.reshape(driver.batches, driver.b)
    # every batch holds one set of each kind, at positions that differ
    assert all(sorted(k) == [0, 1, 2, 3, 4] for k in kinds)
    assert not all((k == kinds[0]).all() for k in kinds)
    correct, checks, failed = judge(mod, driver)
    assert correct and not failed, checks


def test_verify_control(root):
    correct, checks, _ = judge(*prepared(root, "verify_tiny",
                                         control_run=True))
    assert not correct and checks["wrong_verdicts"][0] >= 1


def verify_fault(kind, verify_batch):
    if kind == "half_batch":
        def broken(pk, msgs, sig, g1_gen, *args, **kw):
            half = -(-len(msgs) // 2)
            v = verify_batch(pk[:half], msgs[:half], sig[:half],
                             tuple(t[..., :half] for t in g1_gen), *args,
                             **kw)
            return np.concatenate([v, v])[:len(msgs)]
    elif kind == "altered":
        def broken(*args, **kw):
            v = verify_batch(*args, **kw).copy()
            v[0] = ~v[0]
            return v
    elif kind == "no_key_validate":
        broken = functools.partial(verify_batch, key_validate=False)
    else:
        first = []

        def broken(*args, **kw):
            if not first:
                first.append(verify_batch(*args, **kw))
            return first[0]
    return broken


@pytest.mark.parametrize("kind", ["half_batch", "altered", "unchanged",
                                  "no_key_validate"])
def test_verify_faults(verify, kind, monkeypatch):
    mod, driver = verify
    monkeypatch.setattr(mod, "verify_batch",
                        verify_fault(kind, mod.verify_batch))
    correct, checks, failed = judge(mod, driver)
    assert not correct and failed, (kind, checks)
    if kind == "no_key_validate":
        # the pairing alone accepts (identity, identity), and nothing else
        # that is invalid
        pk, msgs, sig = driver.batch(0)
        verdict = mod.verify_batch(pk, msgs, sig, driver.g1_gen, driver.dst,
                                   driver.device, driver.spans)
        kinds = driver.kinds[:driver.b]
        assert (verdict == ((kinds == mod.HONEST)
                            | (kinds == mod.IDENTITY_KEY))).all()


def children() -> set:
    """The process ids whose parent is this process (Linux `/proc`)."""
    me, out = str(os.getpid()), set()
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[1] == me:
            out.add(stat.parent.name)
    return out


def test_reference_verdicts_over_processes(verify):
    """The reference's verdicts over two worker processes are the serial
    ones, and the labels: valid exactly when honest; no process of ours
    outlives the call."""
    mod, driver = verify
    sets = [(driver.pk_bytes[i].tobytes(), driver.msgs[i].tobytes(),
             driver.sig_bytes[i].tobytes(), driver.dst)
            for i in range(len(driver.msgs))]
    before = children()
    pooled = mod.reference_verdicts(sets, processes=2)
    assert children() == before
    assert pooled == mod.reference_verdicts(sets, processes=1)
    assert pooled == (driver.kinds == mod.HONEST).tolist()


def test_control_script(root):
    out = control.control_run("msm_tiny", 5, 0.0, device="cpu", root=root)
    assert out["correct"] is False and out["attempted"] == \
        TINY["msm_tiny"]["params"]["scalar_sets"]


# cells a card test run holds: the controls at a size of their own
CARD = {"msm_card": {"config": "kzg_commit_g1", "traffic": "commit_2p12",
                     "why": "4096 points on the card",
                     "params": {"points_per_call": 4096, "scalar_sets": 2}},
        "verify_card": {"config": "eth_bls_verify", "traffic": "verify_64",
                        "why": "64 sets on the card",
                        "params": {"sets_per_call": 64, "batches": 2,
                                   "block": 64, "reference_sample": 1}}}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CARD))
def test_sound_and_control_on_the_card(card, cell, tmp_path):
    root = make_root(tmp_path, {cell: CARD[cell]})
    correct, checks, _ = judge(*prepared(root, cell, device=card))
    assert correct, checks
    correct, checks, _ = judge(*prepared(root, cell, control_run=True,
                                         device=card))
    assert not correct, checks
