"""Host ms per traced call in the challenge (the program's span
`kzg.challenge`: the transcript of every cell and its SHA-256, on a thread
of the host; the span carries host stamps only, and a reader takes the
host's time even where a span has stream ms).

Read for the group `.cells`; None untraced or where the program records
no such span (`stages.py`)."""

import stages


def read(run):
    window = stages._window(run, None)
    found = stages.outermost(window, "kzg.challenge") if window else []
    if not found:
        return None
    return sum((s["end_ns"] - s["start_ns"]) * 1e-6
               for s in found) / run.trace.calls
