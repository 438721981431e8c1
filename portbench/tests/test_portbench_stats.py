"""The arithmetic of the end-to-end and per-layer metrics on synthetic
timings and events."""

import statistics

import devtrace
import harness
import roofline
import stats


def closed_loop(latencies, work=128):
    """Calls back to back from t = 0 with the given latencies."""
    calls, t = [], 0.0
    for lat in latencies:
        calls.append((t, t + lat, work))
        t += lat
    return calls


def metric(name, run):
    return harness.Bench().metric_reader(name)(run)


def test_rate_and_p90_of_a_steady_window():
    calls = closed_loop([0.25] * 120)
    run = harness.Run(12.5, calls, {}, None)
    assert abs(metric("verify_sets_per_s", run) - 128 / 0.25) < 1e-9
    assert abs(metric("verify_call_p90_ms", run) - 250.0) < 1e-9
    assert metric("setup_s", run) == 12.5


def test_a_stall_moves_the_rate_and_the_p90():
    steady = closed_loop([0.25] * 120)
    # the host stalls for 20 calls in the middle: each takes 0.6 s
    stalled = closed_loop([0.25] * 50 + [0.6] * 20 + [0.25] * 50)
    r0 = stats.rate(steady)
    r1 = stats.rate(stalled)
    assert r1 < 0.85 * r0
    p0 = stats.percentile(stats.latencies(steady), 90)
    p1 = stats.percentile(stats.latencies(stalled), 90)
    assert p1 > 2 * p0
    # one stall of one call moves the rate but, under the top tenth, not
    # the p90
    one = closed_loop([0.25] * 119 + [5.0])
    assert stats.rate(one) < 0.9 * r0
    assert stats.percentile(stats.latencies(one), 90) == p0


def test_rate_counts_gaps_between_calls():
    calls = [(0.0, 1.0, 10), (3.0, 4.0, 10)]
    assert stats.rate(calls) == 20 / 4.0


def test_percentile_nearest_rank():
    values = list(range(1, 101))
    assert stats.percentile(values, 90) == 90
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([], 90) is None
    assert stats.percentile(list(range(1, 11)), 90) == 9


def test_spread_is_the_quartile_distance_over_the_median():
    values = [100, 101, 99, 100, 102, 98]
    q1, q2, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == (q3 - q1) / q2


def test_busy_union_and_idle_gaps():
    ivs = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.busy_seconds(ivs) == 3.0
    assert stats.idle_gaps(ivs, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                               (4.0, 5.0)]


def synthetic_trace():
    events = [("void (anonymous namespace)::plan_kernel<4>(int const*)",
               0.000, 0.010),
              ("void at::native::vectorized_elementwise_kernel<4, F>(int)",
               0.010, 0.015),
              ("Memcpy DtoH (Device -> Pageable)", 0.015, 0.016),
              ("void mont_pow_kernel<Fp, 4, 32>(PowIO)", 0.030, 0.035),
              ("void xmd_sha256_kernel<16>(unsigned char const*)",
               0.035, 0.036)]
    spans = [("pairing", -0.001, 0.020), ("verdict", 0.020, 0.029)]
    return devtrace.Trace(events, spans, 2, 0.0, 0.040)


def test_trace_quantities():
    tr = synthetic_trace()
    assert devtrace.launches_per_call(tr) == 2.0
    assert abs(devtrace.port_kernel_ms_per_call(tr) - 8.0) < 1e-9
    assert abs(devtrace.glue_device_ms_per_call(tr) - 3.0) < 1e-9
    assert abs(devtrace.device_idle_share(tr) - (1 - 0.022 / 0.040)) < 1e-9
    bd = devtrace.breakdown(tr)
    assert bd["device_ops"][0][0] == "plan_kernel<4>"
    assert len(bd["device_ops"]) == 5
    # [0.016, 0.030] mostly under "verdict", [0.036, 0.040] under none
    assert bd["idle_gaps"][0][0] == "verdict: 1 gaps, longest 0.014000 s"
    assert abs(bd["idle_gaps"][0][1] - 0.014) < 1e-9
    assert bd["idle_gaps"][1][0].startswith("between calls: 1 gaps")
    for name in ("launches_per_call.verify", "glue_device_ms_per_call.verify",
                 "port_kernel_ms_per_call.verify",
                 "device_idle_share.verify"):
        assert metric(name, harness.Run(1.0, [], {}, tr)) is not None
        assert metric(name, harness.Run(1.0, [], {}, None)) is None


def test_port_kernel_names():
    assert devtrace.is_port_kernel("void sop_rows_kernel<Fp>(A)")
    assert devtrace.is_port_kernel("sha256_kernel")
    assert not devtrace.is_port_kernel("void at::native::reduce_kernel<512>")
    assert not devtrace.is_port_kernel("my_sha256_kernel_copy")


def test_roofline_share_of_a_synthetic_msm():
    tr = synthetic_trace()
    fp_products = 1_000_000
    run = harness.Run(1.0, [], {"roofline": {"fp_products": fp_products}},
                      tr)
    least_s = fp_products * roofline.sop_imads(1) / roofline.IMAD_PER_S
    want = 100 * least_s / 0.008
    assert abs(metric("msm_port_kernels_roofline", run) - want) < 1e-9


def test_frozen_counts():
    # the values chip_smoke.py and utils/profiling.py give
    assert roofline.sop_imads(1) == 588 and roofline.sop_imads(1, 8) == 264
    assert roofline.IMAD_PER_S == 132 * 64 * 1.98e9


def test_pippenger_counts_frozen_in_the_cells():
    for cell, n in (("msm_g1_2p20", 1 << 20), ("msm_g1_blob4096", 4096)):
        traffic = harness.Bench().traffic(cell)
        assert traffic["points_per_call"] == n
        c = roofline.best_window(n)
        assert traffic["roofline"] == {
            "window": c, "fp_products": roofline.pippenger_products(n, c)}
