"""Stream ms per traced call in the key aggregation's gather (the program's
span `agg.gather`: the registry's keys read by index, lifted to z = 1).

Read for the group `.agg`; None untraced or where the program records no
such span (`stages.py`)."""

import stages


def read(run):
    return stages.ms_per_call(run, "agg.gather")
