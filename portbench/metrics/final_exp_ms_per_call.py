"""Stream ms per traced call in the pairing's final exponentiation (the
program's span `pairing.final_exp`).

One reader for the groups `.verify` and `.block`, each moving its own
end-to-end metric; None untraced or where the program records no spans
(`stages.py`)."""

import stages


def read(run):
    return stages.ms_per_call(run, "pairing.final_exp")
