"""Stream ms per traced call in the decoders' subgroup checks (the
program's span `codec.subgroup`: `is_torsion_free` of G1 and G2).

One reader for the groups `.verify` and `.block`, each moving its own
end-to-end metric; None untraced or where the program records no spans
(`stages.py`)."""

import stages


def read(run):
    return stages.ms_per_call(run, "codec.subgroup")
