"""The validator key registry and its sums (`ops/aggregate.py`) on the
card: the checks of `tests/test_torch_aggregate.py` at widths the CPU
cannot reach.  Registration of 2^12 keys made on the card with malformed
rows among them; ragged sums by index over a 2^15-key table, a set of
24,576 keys (an Electra attestation's) and the whole table among them,
each equal to the host's [sum (i+1)]G1; FastAggregateVerify's verdicts
equal to the plain reference's for every invalid kind; the spans with
the fold's launches counted and their stream time read (under
`emit_nvtx`, so no CUPTI session of this file precedes another file's in
one process).

Tolerance: none (integer arithmetic).  Every test needs a CUDA device:
without one it skips (the `gpu` marker).  From the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_aggregate_gpu.py
"""

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from bls12_381_torch import hostmath as hm
from bls12_381_torch.curves import g1
from bls12_381_torch.fields import fp
from bls12_381_torch.kernels import AGGREGATES
from bls12_381_torch.ops import aggregate, msm
from bls12_381_torch.utils import profiling, scans
from test_torch_aggregate import (DST, affine_ints, compressed,
                                  fast_aggregate_verify, flat, host_keys,
                                  host_sum, malformed, reference,
                                  verify_cases)

pytestmark = pytest.mark.gpu
LOG_TABLE = 15


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def card_keys(n: int, dev) -> np.ndarray:
    """[i+1]G1 for i < n made on the card by a scan of the group law,
    compressed: uint8 [n, 48]."""
    pts = scans.inclusive_scan(g1.add, g1.generator((n,), dev),
                               g1.identity((1,), dev))
    return g1.to_compressed_host(g1.to_affine(pts))


@pytest.fixture(scope="module")
def registry(cuda):
    reg = aggregate.KeyRegistry(cuda)
    assert reg.register(card_keys(1 << LOG_TABLE, cuda)).all()
    return reg


def test_register_on_the_card(cuda):
    n = 1 << 12
    keys = card_keys(n, cuda)
    assert (keys == compressed(host_keys(n))).all()
    bad = np.array([np.frombuffer(b, np.uint8)
                    for b in malformed().values()])
    rows = np.concatenate([keys[:1000], bad, keys[1000:]])
    reg = aggregate.KeyRegistry(cuda)
    taken = reg.register(rows)
    assert taken.tolist() == [True] * 1000 + [False] * len(bad) + \
        [True] * (n - 1000)
    x, y = reg.xy
    assert x.device.type == "cuda" and len(reg) == n
    assert list(zip(fp.to_ints(x.cpu()), fp.to_ints(y.cpu()))) == \
        host_keys(n)


def test_ragged_sums_on_the_card(registry):
    n = len(registry)
    rng = np.random.default_rng(11)
    sets = [[], [5], np.sort(rng.choice(n, 24576, replace=False)).tolist(),
            [], list(range(n)), [7, 7, 3], rng.choice(n, 1024).tolist(), []]
    before = AGGREGATES.snapshot()
    apk, filled = registry.aggregate(*flat(sets))
    assert filled.device.type == "cuda"
    assert filled.tolist() == [len(s) > 0 for s in sets]
    assert affine_ints(tuple(t.cpu() for t in apk)) == host_sum(sets)
    assert AGGREGATES.snapshot()["keys"] - before["keys"] == \
        sum(map(len, sets))


def test_fast_aggregate_verify_on_the_card(cuda):
    keys = host_keys(10) + [hm.g1_neg(host_keys(1)[0])]
    reg = aggregate.KeyRegistry(cuda)
    assert reg.register(compressed(keys)).all()
    sets, msgs, sigs, labels = verify_cases(len(keys))
    got = fast_aggregate_verify(reg, sets, msgs, sigs, device=cuda)
    enc = compressed(keys)
    want = [reference.fast_aggregate_verify(
        [enc[i].tobytes() for i in s], msgs[j].tobytes(), sigs[j].tobytes(),
        DST) for j, s in enumerate(sets)]
    assert want == labels and got.tolist() == labels


def test_spans_on_the_card(registry):
    sets = [list(range(1000)), [3], list(range(2000, 2600))]
    profiling.clear()
    try:
        # a session that records spans without CUPTI: the stream times
        # come from the spans' own CUDA events
        with autograd_profiler.emit_nvtx():
            registry.aggregate(*flat(sets))
        spans = profiling.spans()
    finally:
        profiling.clear()
    assert [s["name"] for s in spans] == ["agg", "agg.gather", "agg.sum"]
    top, gather, total = spans
    assert gather["parent"] == total["parent"] == top["id"]
    # the fold's launches, one a level, are the port's, all in agg.sum
    assert total["launches"] == len(msm.fold_levels(1601))
    assert gather["launches"] == 0 and top["launches"] == total["launches"]
    assert all(s["stream_ms"] > 0 for s in spans)
    assert top["stream_ms"] >= total["stream_ms"]
