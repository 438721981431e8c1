"""The program's own spans over a traced run, per traced call.

The program (`bls12_381_torch.utils.profiling`) records a span at each
stage boundary of its public paths while a torch.profiler session is
active, as it is over the traced calls: its name, id and parent, its start
and end on the host's wall clock in ns (the clock of `devtrace`'s events),
the port's kernel launches inside it, and its time on the stream from a
pair of CUDA events (None off the card).  A quantity here sums, over the
spans inside the traced calls' window, the outermost occurrences of one
name (an MSM inside an MSM counts once), and divides by the traced calls.
An untraced run, or a program that records no spans, gives None.
"""

from __future__ import annotations


def program_spans() -> list | None:
    """The program's recorded spans, or None where it records none."""
    try:
        from bls12_381_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return read() if callable(read) else None


def in_window(spans, trace) -> list:
    """The closed spans that lie in [trace.start, trace.end]."""
    lo, hi = trace.start * 1e9, trace.end * 1e9
    return [s for s in spans if s["end_ns"] is not None
            and lo <= s["start_ns"] and s["end_ns"] <= hi]


def outermost(spans, name: str) -> list:
    """The spans named `name` with no span of that name around them."""
    by_id = {s["id"]: s for s in spans}
    out = []
    for s in spans:
        if s["name"] != name:
            continue
        up = by_id.get(s["parent"])
        while up is not None and up["name"] != name:
            up = by_id.get(up["parent"])
        if up is None:
            out.append(s)
    return out


def stream_ms(s: dict) -> float:
    """A span's time on the stream, or its host duration off the card."""
    if s["stream_ms"] is not None:
        return s["stream_ms"]
    return (s["end_ns"] - s["start_ns"]) * 1e-6


def _window(run, spans) -> list | None:
    if run.trace is None:
        return None
    if spans is None:
        spans = program_spans()
    if not spans:
        return None
    return in_window(spans, run.trace) or None


def ms_per_call(run, name: str, spans=None) -> float | None:
    """Stream ms per traced call in the outermost spans `name`."""
    window = _window(run, spans)
    found = outermost(window, name) if window else []
    if not found:
        return None
    return sum(stream_ms(s) for s in found) / run.trace.calls


def port_launches_per_call(run, spans=None) -> float | None:
    """The port's kernel launches per traced call inside the top-level
    spans (those with no span of the window around them)."""
    window = _window(run, spans)
    if not window:
        return None
    ids = {s["id"] for s in window}
    top = [s for s in window if s["parent"] not in ids]
    return sum(s["launches"] for s in top) / run.trace.calls
