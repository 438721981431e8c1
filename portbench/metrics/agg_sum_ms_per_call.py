"""Stream ms per traced call in the key aggregation's sum (the program's
span `agg.sum`: the segmented scan of the group law over every set's
keys and the sets' tails).

Read for the group `.agg`; None untraced or where the program records no
such span (`stages.py`)."""

import stages


def read(run):
    return stages.ms_per_call(run, "agg.sum")
