"""Stream ms per traced call in the decode (the program's span
`kzg.decode`: the spec's length and index checks, the commitments'
deduplication, the commitments' and proofs' decompression with subgroup
checks, the field elements' big-endian decode on the card).

Read for the group `.cells`; None untraced or where the program records
no such span (`stages.py`)."""

import stages


def read(run):
    return stages.ms_per_call(run, "kzg.decode")
