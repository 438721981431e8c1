"""Stream ms per traced call in the pairing's G2 preparation and Miller
loop (the program's span `pairing.miller`).

One reader for the groups `.verify` and `.block`, each moving its own
end-to-end metric; None untraced or where the program records no spans
(`stages.py`)."""

import stages


def read(run):
    return stages.ms_per_call(run, "pairing.miller")
