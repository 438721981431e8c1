"""The MSM's CUDA graphs on the card (`utils/graphs.py`, `graphed`): the
third and later calls at a shape replay its graph and must equal the eager
call limb for limb, in projective coordinates, and the host's
[sum_i k_i (i+1)]G (`port_cases.msm_host_sum`, hostmath), with the graph's
static inputs refreshed on every call and replays from two streams kept in
order; a capture at a point a graph cannot hold raises and leaves the
shape eager, counted; a graph beyond the budget is not kept; evicting a
shape frees its pool, and so does running out of memory in the MSM or in
another path; a replay under the profiler records the eager call's stages
and kernels.

Tolerance: none (integer arithmetic).  Every test needs a CUDA device:
without one it skips (the `gpu` marker).  From the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_msm_graph_gpu.py
"""

import collections
import gc
from collections import Counter

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import port_cases
from bls12_381_torch import entry, hostmath as hm, params
from bls12_381_torch.curves import g1, g2
from bls12_381_torch.kernels import GRAPHS, LAUNCHES
from bls12_381_torch.ops import msm, ntt
from bls12_381_torch.utils import graphs, profiling

pytestmark = pytest.mark.gpu
C = 12
PORT_KERNELS = ("plan_kernel", "sop_rows_kernel", "sqr_kernel",
                "mont_pow_kernel", "fp2_pow_kernel")


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


def equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        [t.cpu() for t in _leaves(a)], [t.cpu() for t in _leaves(b)]))


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [t for part in x for t in _leaves(part)]
    return [x]


def counts(captures, replays, eager, fallbacks=0, oversize=0) -> dict:
    return {"captures": captures, "replays": replays, "eager": eager,
            "fallbacks": fallbacks, "oversize": oversize}


def host_msm(group, pts, scalars, factor=1):
    """The host's affine [factor sum_i k_i (i+1) mod q]G over the lanes
    where `pts` holds no identity: `entry.msm_inputs`' points are [i+1]G
    or the identity, and factor [i+1]G after `factor` doublings."""
    mod = {"g1": g1, "g2": g2}[group]
    skip = mod.is_identity(pts).cpu().numpy()
    total = factor * port_cases.msm_host_sum(scalars, skip) % params.Q
    gen = {"g1": params.G1_GEN, "g2": params.G2_GEN}[group]
    return {"g1": hm.g1_mul, "g2": hm.g2_mul}[group](gen, total)


def is_host_msm(group, got, pts, scalars, factor=1) -> bool:
    return port_cases.affine_ints(group, got) == host_msm(group, pts,
                                                          scalars, factor)


def scalar_sets(log_n, dev, n_sets=4):
    """n_sets scalar vectors (entry's, zero at i % 64 == 9) and one all
    zero."""
    sets = [entry._scalars(log_n, seed, dev) for seed in range(n_sets)]
    return sets + [torch.zeros_like(sets[0])]


@pytest.mark.parametrize("glv", [True, False])
@pytest.mark.parametrize("log_n", [12, 16])
def test_msm_g1_replays_equal_eager(cuda, log_n, glv):
    """Four scalar sets, then a second point set (the doubles, and all
    identity): each call at the shape = the eager body's point."""
    pts, _ = entry.msm_inputs(log_n, "g1", device=cuda)
    n = 1 << log_n
    # (points, their multiple of [i+1]G on the lanes pts does not skip)
    point_sets = [(pts, 1), (g1.double(pts), 2),
                  (g1.identity((n,), cuda), 0)]
    calls = [(p, f, s) for p, f in point_sets[:1]
             for s in scalar_sets(log_n, cuda)]
    calls += [(p, f, calls[0][2]) for p, f in point_sets[1:]]
    for i, (p, f, s) in enumerate(calls):
        got = msm.msm_g1(p, s, C, glv)
        assert equal(got, msm._msm_g1(p, s, C, glv)), f"call {i}"
        assert is_host_msm("g1", got, pts, s, f), f"call {i}"
    assert GRAPHS.snapshot() == counts(1, len(calls) - 1, 1)
    # what a caller holds is its own: a later replay leaves it as it was
    first = msm.msm_g1(pts, calls[0][2], C, glv)
    keep = [t.clone() for t in first]
    msm.msm_g1(point_sets[1][0], calls[1][2], C, glv)
    assert equal(first, keep)


def test_msm_g1_large_chunks_share_one_graph(cuda):
    pts, k = entry.msm_inputs(13, "g1", device=cuda)
    k2 = entry._scalars(13, 7, cuda)
    half = 1 << 12

    def eager(s):
        parts = [msm._msm_g1(tuple(t[..., i:i + half] for t in pts),
                             s[..., i:i + half], C, True)
                 for i in (0, half)]
        return g1.add(*parts)

    for s in (k, k2, k):
        got = msm.msm_g1_large(pts, s, C, chunk_log2=12)
        assert equal(got, eager(s)) and is_host_msm("g1", got, pts, s)
    # one key: the first chunk eager, the second captures, then replays
    assert GRAPHS.snapshot() == counts(1, 5, 1)
    assert len(graphs._graphs) == 1


def test_msm_g2_replays_equal_eager(cuda):
    pts, k = entry.msm_inputs(12, "g2", device=cuda)
    sets = scalar_sets(12, cuda, n_sets=2)
    for s in sets + sets[:1]:
        got = msm.msm_g2(pts, s, C)
        assert equal(got, msm._msm_g2(pts, s, C, True))
        assert is_host_msm("g2", got, pts, s)
    assert GRAPHS.snapshot() == counts(1, len(sets), 1)


def test_replays_on_two_streams_keep_their_order(cuda):
    """Replays at one shape from two streams, with no wait between the
    callers: each point is its own scalars' (a caller's copy into the
    static inputs waits for the previous replay's output to be read)."""
    pts, _ = entry.msm_inputs(12, "g1", device=cuda)
    sets = scalar_sets(12, cuda, n_sets=6)
    for _ in range(2):
        msm.msm_g1(pts, sets[0], C)  # eager, then the capture
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    for i, s in enumerate(sets):
        with torch.cuda.stream(streams[i % 2]):
            got.append(msm.msm_g1(pts, s, C))
    torch.cuda.synchronize()
    assert GRAPHS.snapshot() == counts(1, 1 + len(sets), 1)
    for i, (s, p) in enumerate(zip(sets, got)):
        assert is_host_msm("g1", p, pts, s), f"call {i}"


def test_a_graph_beyond_the_budget_is_not_kept(cuda, monkeypatch):
    """With a budget of ~80 KB the capture is replayed once and dropped;
    the shape runs eagerly after, every call the host's point."""
    monkeypatch.setattr(graphs, "POOL_SHARE", 1e-6)
    pts, _ = entry.msm_inputs(12, "g1", device=cuda)
    sets = scalar_sets(12, cuda, n_sets=3)
    for i, s in enumerate(sets):
        assert is_host_msm("g1", msm.msm_g1(pts, s, C), pts, s), f"call {i}"
    assert GRAPHS.snapshot() == counts(1, 1, len(sets) - 1, oversize=1)
    key = graphs._key(msm._msm_g1, (pts, sets[0]), C, True)
    assert graphs._graphs[key] == graphs._EAGER and not graphs._held()


@pytest.mark.parametrize("log_n", [12, 20])
def test_no_fallback_at_the_cells_shapes(cuda, log_n):
    """The benchmark's calls: msm_g1_large at the library's defaults over
    one blob and over 2^20 points."""
    pts, k = entry.msm_inputs(log_n, "g1", device=cuda)
    launches = []
    for i in range(3):
        before = LAUNCHES.port_total()
        got = msm.msm_g1_large(pts, k)
        launches.append(LAUNCHES.port_total() - before)
        assert is_host_msm("g1", got, pts, k), f"call {i}"
    assert GRAPHS.snapshot() == counts(1, 2, 1)
    # a replay counts the launches the eager call made
    assert launches[0] == launches[1] == launches[2] > 0


def test_evicting_a_shape_frees_its_pool(cuda):
    pts, k = entry.msm_inputs(16, "g1", device=cuda)
    for c in (9, 10, 11, 12):
        for _ in range(3):
            msm.msm_g1(pts, k, c)
    assert GRAPHS.captures == 4 and len(graphs._graphs) == graphs.SLOTS
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    msm.msm_g1(pts, k, 13)  # a fifth shape: the first (c = 9) goes
    assert len(graphs._graphs) == graphs.SLOTS
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() < held


def test_a_capture_at_an_unsupported_point_raises(cuda):
    """A host read inside a capture raises in the default global mode;
    `graphed` counts the fallback and runs that shape eagerly after."""
    x = torch.arange(1 << 10, device=cuda)

    def body(t):
        return t * int(t.sum().item())

    with pytest.raises(RuntimeError):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            body(x)
    want = body(x)
    for _ in range(3):
        assert torch.equal(graphs.graphed("test.replay", body, (x,)), want)
    assert GRAPHS.snapshot() == counts(0, 0, 3, fallbacks=1)
    # the card is usable after the failed capture
    pts, k = entry.msm_inputs(12, "g1", device=cuda)
    assert equal(msm.msm_g1(pts, k, C), msm._msm_g1(pts, k, C, True))


def fill_to_cap(cuda, spare: int) -> list:
    """Cap the allocator `spare` bytes above what it holds, and take every
    free byte of its segments and of the cap but `spare`: the tensors that
    hold them (64 MB, then 2 MB at a time)."""
    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(cuda).total_memory
    torch.cuda.set_per_process_memory_fraction(
        (torch.cuda.memory_reserved() + spare) / total)
    held = []
    for size in (64 << 20, 2 << 20):
        try:
            while True:
                held.append(torch.empty(size, dtype=torch.uint8,
                                        device=cuda))
        except torch.OutOfMemoryError:
            pass
    del held[-(spare >> 21):]
    return held


def test_out_of_memory_drops_the_graphs(cuda):
    """With a 2^20 graph kept and 256 MB free under a cap, an eager call at
    2^18 (over 512 MB at its peak) runs out of memory, drops the graph and
    runs once more; the 2^20 shape captures again at its next call."""
    big, kb = entry.msm_inputs(20, "g1", device=cuda)
    for _ in range(2):
        msm.msm_g1(big, kb, C)
    key = graphs._key(msm._msm_g1, (big, kb), C, True)
    assert isinstance(graphs._graphs[key], graphs._Graph)
    small, ks = entry.msm_inputs(18, "g1", device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    want = msm._msm_g1(small, ks, C, True)
    assert torch.cuda.max_memory_allocated() - held > 2 * (256 << 20)
    filler = fill_to_cap(cuda, 256 << 20)
    try:
        got = msm.msm_g1(small, ks, C)
    finally:
        del filler
        torch.cuda.set_per_process_memory_fraction(1.0)
    assert equal(got, want)
    assert graphs._graphs[key] == graphs._SEEN
    assert equal(msm.msm_g1(big, kb, C), msm._msm_g1(big, kb, C, True))
    assert GRAPHS.captures == 2 and GRAPHS.fallbacks == 0


def test_out_of_memory_in_another_path_drops_the_graphs(cuda):
    """With a 2^20 graph kept and 256 MB free under a cap, an NTT over
    2^22 coefficients (over 512 MB at its peak) runs out of memory, drops
    the graph and runs once more."""
    big, kb = entry.msm_inputs(20, "g1", device=cuda)
    for _ in range(2):
        msm.msm_g1(big, kb, C)
    key = graphs._key(msm._msm_g1, (big, kb), C, True)
    assert isinstance(graphs._graphs[key], graphs._Graph)
    coeffs = entry.ntt_inputs(22, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    want = ntt.ntt(coeffs)
    assert torch.cuda.max_memory_allocated() - held > 2 * (256 << 20)
    filler = fill_to_cap(cuda, 256 << 20)
    try:
        got = ntt.ntt(coeffs)
    finally:
        del filler
        torch.cuda.set_per_process_memory_fraction(1.0)
    assert torch.equal(got, want)
    assert graphs._graphs[key] == graphs._SEEN


def device_kernels(prof) -> Counter:
    return Counter(e.name() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA
                   and any(k in e.name() for k in PORT_KERNELS))


def test_a_replay_under_the_profiler(cuda):
    """Call 1 (eager) and call 3 (a replay) under torch.profiler: the same
    port kernels on the device, the same launch count; the replay's spans
    are msm > msm.replay > the 23 stages of c = 12, each inside msm's
    stream time."""
    pts, k = entry.msm_inputs(12, "g1", device=cuda)
    runs = []
    for i in range(3):
        profiling.clear()
        before = LAUNCHES.port_total()
        if i == 1:
            msm.msm_g1(pts, k, C)
            continue
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            msm.msm_g1(pts, k, C)
            torch.cuda.synchronize()
        runs.append((LAUNCHES.port_total() - before, device_kernels(prof),
                     profiling.spans()))
    assert GRAPHS.captures == 1 and GRAPHS.replays == 2
    (eager_n, eager_k, eager_s), (replay_n, replay_k, spans) = runs
    assert replay_n == eager_n and replay_k == eager_k
    assert sum(replay_k.values()) == replay_n
    windows = sum(s["name"] == "msm.buckets" for s in eager_s)
    assert len(spans) == 25 == len(eager_s) + 1 and windows == 11
    (top,) = [s for s in spans if s["parent"] is None]
    (replay,) = [s for s in spans if s["parent"] == top["id"]]
    assert (top["name"], replay["name"]) == ("msm", "msm.replay")
    assert Counter(s["name"] for s in spans if s["parent"] == replay["id"]) \
        == {"msm.recode": 1, "msm.buckets": 11, "msm.window_sum": 11}
    assert top["launches"] == replay["launches"] == eager_n
    stages = [s for s in spans if s["parent"] == replay["id"]]
    assert sum(s["launches"] for s in stages) == eager_n
    assert all(0 < s["stream_ms"] <= replay["stream_ms"] <= top["stream_ms"]
               for s in stages)
    assert sum(s["stream_ms"] for s in stages) <= top["stream_ms"]
    profiling.clear()
