"""Stream ms per traced call in hash to curve's cofactor clearing (the
program's span `h2c.clear`).

One reader for the groups `.verify` and `.block`, each moving its own
end-to-end metric; None untraced or where the program records no spans
(`stages.py`)."""

import stages


def read(run):
    return stages.ms_per_call(run, "h2c.clear")
