"""PeerDAS cell-proof batch verification (`ops/kzg.py`) on the card: the
card's verdict equals the CPU path's and the reference's for the honest
batch and every fault of `tests/test_torch_kzg.py`'s case; LL and RL of
512 cells made on the card by the benchmark's configuration module
(`portbench/configs/eth_das_cell_verify.py`: the port's NTT and scalar
multiplications) equal the CPU path's as affine points; a replay
of the path's graphs equals the eager call; the spans and
`kernels.CELLS` as the CPU tests state them, with the stream times read
(under `emit_nvtx`, so no CUPTI session of this file precedes another
file's in one process).

Tolerance: none (integer arithmetic).  Every test needs a CUDA device:
without one it skips (the `gpu` marker).  From the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kzg_gpu.py
"""

import importlib.util
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from bls12_381_torch.curves import g1
from bls12_381_torch.kernels import CELLS, GRAPHS
from bls12_381_torch.ops import kzg
from bls12_381_torch.utils import graphs, profiling, scans
from test_torch_kzg import (KINDS, arrays, make_case, port_setup,
                            reference_verdict, with_fault)

pytestmark = pytest.mark.gpu
CONFIG = Path(__file__).resolve().parent.parent / "portbench" / "configs" \
    / "eth_das_cell_verify.py"
TAU = 0x5EED_0000_1234_5678_9ABC_DEF0_1357_9BDF_2468_ACE0


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def case(cuda):
    _, setup, batch = make_case()
    return {"setup": setup, "batch": batch, "card": port_setup(setup, cuda),
            "cpu": port_setup(setup, "cpu")}


def das_config():
    spec = importlib.util.spec_from_file_location("das_config", CONFIG)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def epoch(cuda):
    """512 cells (one block of 4 blobs, every column) made on the card by
    the benchmark's configuration module, and its setup on the card and
    on the CPU."""
    d = das_config()
    setup, _ = d.make_setup(TAU, cuda)
    batch = d.make_epoch(1, 4, TAU, np.random.default_rng(5), cuda)
    cpu = kzg.Setup(*scans.tree_map(lambda t: t.cpu(), (
        setup.g1_monomial, setup.g2_tau_n)))
    return {"config": d, "card": setup, "batch": batch, "cpu": cpu}


def affine_ints(p):
    from bls12_381_torch.fields import fp

    x, y, inf = g1.to_affine(tuple(t.unsqueeze(-1) for t in p))
    return (None if bool(inf[0]) else
            (int(fp.to_ints(x)[0]), int(fp.to_ints(y)[0])))


def lincombs(args, setup, device):
    parsed = kzg._parse(*args)
    dec = kzg._decode_device(parsed, device)
    return kzg._lincombs(dec, kzg.challenge(*parsed), setup)


@pytest.mark.parametrize("kind", KINDS)
def test_card_verdict_equals_cpu_and_reference(case, kind):
    batch = with_fault(case["batch"], kind)
    want = reference_verdict(batch, case["setup"])
    assert want == (kind == "honest")
    card = kzg.verify_cell_kzg_proof_batch(*arrays(batch), case["card"])
    cpu = kzg.verify_cell_kzg_proof_batch(*arrays(batch), case["cpu"])
    assert card is cpu is want


def test_lincombs_equal_the_cpu_paths_at_512_cells(epoch, cuda):
    b = epoch["batch"]
    args = (b["commitments"], b["cell_indices"], b["cells"], b["proofs"])
    assert args[2].shape == (512, 2048)
    card = [affine_ints(p) for p in lincombs(args, epoch["card"], cuda)]
    cpu = [affine_ints(p) for p in lincombs(args, epoch["cpu"], "cpu")]
    assert card == cpu and None not in card
    assert kzg.verify_cell_kzg_proof_batch(*args, epoch["card"]) is True
    d = epoch["config"]
    for kind in (d.WRONG_EVAL, d.WRONG_COMMITMENT):
        bad, _ = d.make_fault(b, kind, np.random.default_rng(kind))
        assert kzg.verify_cell_kzg_proof_batch(*d.batch_args(bad),
                                               epoch["card"]) is False


def test_a_replay_equals_the_eager_call(epoch, cuda):
    b = epoch["batch"]
    args = (b["commitments"], b["cell_indices"], b["cells"], b["proofs"])
    graphs.release()
    graphs._graphs.clear()
    d = epoch["config"]
    bad, _ = d.make_fault(b, d.SWAPPED_PROOFS, np.random.default_rng(3))
    before = GRAPHS.snapshot()
    verdicts = [kzg.verify_cell_kzg_proof_batch(*a, epoch["card"])
                for a in (args, args, d.batch_args(bad), args)]
    assert verdicts == [True, True, False, True]
    counts = GRAPHS.since(before)
    # the decode, the interpolation and the pairing: eager at the first
    # call, captured at the second; the MSM's shape, called twice a call,
    # captures at the first call's second MSM
    assert counts["captures"] == 4 and counts["fallbacks"] == 0
    assert counts["replays"] == 1 + 3 * 5
    replayed = [affine_ints(p) for p in lincombs(args, epoch["card"], cuda)]
    assert GRAPHS.since(before)["replays"] == 1 + 3 * 5 + 4
    graphs.release()
    graphs._graphs.clear()
    eager = [affine_ints(p) for p in lincombs(args, epoch["card"], cuda)]
    assert replayed == eager


def test_spans_and_counter_on_the_card(epoch, cuda):
    b = epoch["batch"]
    args = (b["commitments"], b["cell_indices"], b["cells"], b["proofs"])
    for _ in range(2):  # the graphs captured
        kzg.verify_cell_kzg_proof_batch(*args, epoch["card"])
    before = CELLS.snapshot()
    profiling.clear()
    try:
        # a session that records spans without CUPTI: the stream times
        # come from the spans' own CUDA events
        with autograd_profiler.emit_nvtx():
            assert kzg.verify_cell_kzg_proof_batch(*args, epoch["card"])
        spans = profiling.spans()
    finally:
        profiling.clear()
    assert CELLS.since(before) == {
        "calls": 1, "cells": 512, "commitments": 4, "refused_decode": 0,
        "refused_pairing": 0, "accepted": 1}
    top = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in top] == ["kzg"]
    stages = {s["name"]: s for s in spans if s["parent"] == top[0]["id"]}
    assert list(stages) == ["kzg.decode", "kzg.challenge", "kzg.interp",
                            "kzg.msm", "kzg.pairing"]
    names = Counter(s["name"] for s in spans)
    for name in ("codec.replay", "kzg.interp.replay", "pairing.replay"):
        assert names[name] == 1, name
    assert names["msm.replay"] == 2 and names["msm"] == 2
    assert stages["kzg.challenge"]["stream_ms"] is None
    assert stages["kzg.challenge"]["launches"] == 0
    for name in ("kzg.decode", "kzg.interp", "kzg.msm", "kzg.pairing"):
        assert stages[name]["stream_ms"] > 0, name
    assert top[0]["launches"] == sum(s["launches"] for s in stages.values())
    assert top[0]["launches"] > 0
