"""Stream ms per traced call in the decoders' square roots (the program's
span `codec.sqrt`: `fp.sqrt` in G1, `fp2_sqrt` in G2).

One reader for the groups `.verify` and `.block`, each moving its own
end-to-end metric; None untraced or where the program records no spans
(`stages.py`)."""

import stages


def read(run):
    return stages.ms_per_call(run, "codec.sqrt")
