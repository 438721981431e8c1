"""The arithmetic of the end-to-end metrics and of their spread.

A run's calls are (start, end, work) on the host clock in seconds, each
call a closed-loop request that ended with its answer on the host.
"""

from __future__ import annotations

import math
import statistics


def rate(calls) -> float | None:
    """Work completed per second over the whole window: all the work of
    every call, over the time from the first call's start to the last
    call's end (a stall anywhere in the window counts)."""
    if not calls:
        return None
    span = calls[-1][1] - calls[0][0]
    return sum(work for _, _, work in calls) / span if span > 0 else None


def percentile(values, pct: float) -> float | None:
    """The nearest-rank percentile: the least value with at least pct % of
    the values at or below it."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(1, math.ceil(pct / 100 * len(ordered)))
    return ordered[rank - 1]


def latencies(calls) -> list[float]:
    return [end - start for start, end, _ in calls]


def spread(values) -> float:
    """The distance between the first and third quartile as a share of the
    median, quartiles as `statistics.quantiles(values, n=4)` gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def busy_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


def idle_gaps(intervals, start: float, end: float):
    """The gaps (gap_start, gap_end) in [start, end] that no interval
    covers."""
    gaps, reach = [], start
    for s, e in sorted(intervals):
        if s > reach:
            gaps.append((reach, min(s, end)))
        reach = max(reach, e)
        if reach >= end:
            break
    if reach < end:
        gaps.append((reach, end))
    return [(a, b) for a, b in gaps if b > a]
