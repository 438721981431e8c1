"""Stream ms per traced call in the MSMs (the program's span `kzg.msm`: LL
and RL as two `msm_g1` over the commitments, the setup's 64 points and
the proofs).

Read for the group `.cells`; None untraced or where the program records
no such span (`stages.py`)."""

import stages


def read(run):
    return stages.ms_per_call(run, "kzg.msm")
