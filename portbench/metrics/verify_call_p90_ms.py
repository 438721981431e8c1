"""The 90th percentile (nearest rank) of one batch's latency over every
call of the window, bytes in to verdicts on the host, in ms."""

import stats


def read(run):
    p90 = stats.percentile(stats.latencies(run.calls), 90)
    return None if p90 is None else 1e3 * p90
