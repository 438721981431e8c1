"""Stream ms per traced call in the interpolation (the program's span
`kzg.interp`: r's powers, each cell's 64-point inverse NTT, the coset
shift, the weights, the sum to 64 coefficients and the MSMs' scalars).

Read for the group `.cells`; None untraced or where the program records
no such span (`stages.py`)."""

import stages


def read(run):
    return stages.ms_per_call(run, "kzg.interp")
