"""Stream ms per traced call in the MSM's bucket accumulation (the
program's span `msm.buckets`, once a window): the gather, the y negation,
the segmented scan and the bucket tails.

One reader for the groups `.msm` and `.blob`, each moving its own end-to-
end metric; None untraced or where the program records no spans
(`stages.py`)."""

import stages


def read(run):
    return stages.ms_per_call(run, "msm.buckets")
