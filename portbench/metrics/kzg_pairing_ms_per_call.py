"""Stream ms per traced call in the pairing check (the program's span
`kzg.pairing`: LL and -RL to affine, one two-pair multi-Miller loop and
final exponentiation).

Read for the group `.cells`; None untraced or where the program records
no such span (`stages.py`)."""

import stages


def read(run):
    return stages.ms_per_call(run, "kzg.pairing")
