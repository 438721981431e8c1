"""Signature sets given a verdict in the window, over the window."""

import stats


def read(run):
    return stats.rate(run.calls)
