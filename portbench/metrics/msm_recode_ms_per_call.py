"""Stream ms per traced call in the MSM's recoding (the program's span
`msm.recode`): from_mont, to_affine with its inversion, the GLV split, the
signed digits and the one argsort.

One reader for the groups `.msm` and `.blob`, each moving its own end-to-
end metric; None untraced or where the program records no spans
(`stages.py`)."""

import stages


def read(run):
    return stages.ms_per_call(run, "msm.recode")
