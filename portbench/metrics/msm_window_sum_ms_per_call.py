"""Stream ms per traced call in the MSM's window sums (the program's span
`msm.window_sum`, once a window): the suffix scan, the halving tree, the c
doublings and the add.

One reader for the groups `.msm` and `.blob`, each moving its own end-to-
end metric; None untraced or where the program records no spans
(`stages.py`)."""

import stages


def read(run):
    return stages.ms_per_call(run, "msm.window_sum")
