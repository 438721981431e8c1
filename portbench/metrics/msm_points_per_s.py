"""Points of every commitment completed in the window, over the window."""

import stats


def read(run):
    return stats.rate(run.calls)
