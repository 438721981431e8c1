"""Tracing of the port (counterpart of `bls12_381_tpu/utils/profiling.py`):
a `torch.profiler` scope, and the program's own spans at the stage
boundaries of its public paths, with the peaks of one NVIDIA H100 SXM.

A span records while a `torch.profiler` session is active in the process
and costs one flag read otherwise: its name, its id and the id of the span
around it (per thread), its start and end on the host's wall clock
(`time.time_ns`, the clock the profiler stamps device events on), the
port's kernel launches inside it (`kernels.LAUNCHES.port_total()`) and,
where CUDA is in use, its time on the current stream from a pair of CUDA
events.  Up to MAX_SPANS are kept; the rest are counted in `dropped()`.

A body captured into a CUDA graph runs on the host once, at its capture,
never at its replays.  So inside `capturing()` every span is recorded,
profiler or not, as a template (`Captured`): its name, nesting and launch
count, and its pair of timing events recorded as external events, which
makes them nodes of the graph.  A replay inside `replaying(name, captured)`
is the span `name`, and while a profiler is active the template's spans
are recorded again as its children once the replay is launched: stamped
with the replay's host times, the capture's launch counts, and the stream
ms that the graph's events read after that replay (one wait for the
stream, only while a profiler is active: the next replay rewrites them).

Usage:
    from bls12_381_torch.utils import profiling
    with profiling.trace("traces/pairing"):
        out = pairing(p, q)
    # traces/pairing holds the torch trace (TensorBoard's profiler plugin or
    # chrome://tracing) and program_spans.json: the spans the scope saw

    with profiling.span("pairing.final_exp"):   # in the program
        ...
    profiling.spans()   # [{"name", "id", "parent", "start_ns", "end_ns",
                        #   "launches", "stream_ms"}], oldest first
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

from ..kernels import LAUNCHES

MAX_SPANS = 1 << 16
SPANS_FILE = "program_spans.json"


class _Span:
    """One span: entered and exited once."""
    __slots__ = ("name", "id", "parent", "start_ns", "end_ns",
                 "launches_in", "launches_out", "events", "stream_ms")

    def __init__(self, name: str):
        self.name = name
        self.end_ns = self.launches_out = self.events = self.stream_ms = None

    def __enter__(self):
        global _dropped
        stack = _stack()
        self.parent = stack[-1] if stack else None
        with _lock:
            if len(_spans) >= MAX_SPANS:
                _dropped += 1
                self.id = None
                return self
            self.id = next(_ids)
            _spans.append(self)
        stack.append(self.id)
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.launches_in = LAUNCHES.port_total()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.id is None:
            return False
        self.end_ns = time.time_ns()
        self.launches_out = LAUNCHES.port_total()
        if self.events is not None:
            self.events[1].record()
        _stack().pop()
        return False

    def record(self) -> dict:
        if self.events is not None and self.end_ns is not None:
            start, end = self.events
            end.synchronize()
            self.stream_ms = start.elapsed_time(end)
            self.events = None
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "launches": None if self.launches_out is None
                else self.launches_out - self.launches_in,
                "stream_ms": self.stream_ms}


class _CaptureSpan:
    """A span opened while a CUDA graph is captured: an entry of the
    template."""
    __slots__ = ("rec", "name", "index", "launches_in")

    def __init__(self, rec: "Captured", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        events = None
        if torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True, external=True),
                      torch.cuda.Event(enable_timing=True, external=True))
            events[0].record()
        self.index = len(rec.spans)
        rec.spans.append([self.name, rec.stack[-1] if rec.stack else None,
                          None, events])
        rec.stack.append(self.index)
        self.launches_in = LAUNCHES.port_total()
        return self

    def __exit__(self, *exc):
        entry = self.rec.spans[self.index]
        entry[2] = LAUNCHES.port_total() - self.launches_in
        if entry[3] is not None:
            entry[3][1].record()
        self.rec.stack.pop()
        return False


class Captured:
    """The spans a body opened while it was captured into a CUDA graph, in
    the order they opened: [name, index of the span around it or None,
    port launches inside it, (start, end) events of the graph or None]."""

    def __init__(self):
        self.spans: list[list] = []
        self.stack: list[int] = []

    def emit(self, outer: _Span) -> None:
        """Record the template's spans as children of the open span `outer`
        (the replay): its start, now, the captured launch counts, and the
        stream ms the events read after the replay."""
        global _dropped
        end_ns = time.time_ns()
        ids = []
        for name, up, launches, events in self.spans:
            s = _Span(name)
            s.parent = (outer.parent if outer.id is None else outer.id) \
                if up is None else ids[up]
            s.start_ns, s.end_ns = outer.start_ns, end_ns
            s.launches_in, s.launches_out = 0, launches
            if events is not None:
                events[1].synchronize()
                s.stream_ms = events[0].elapsed_time(events[1])
            with _lock:
                if len(_spans) >= MAX_SPANS:
                    _dropped += 1
                    s.id = None
                else:
                    s.id = next(_ids)
                    _spans.append(s)
            # a dropped span's children hang from its parent, as they do
            # on a call that runs eagerly
            ids.append(s.parent if s.id is None else s.id)


class _Off:
    """The span while no profiler is active: records nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_spans: list[_Span] = []
_dropped = 0
_ids = itertools.count()
_lock = threading.Lock()
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def active() -> bool:
    """Whether a torch.profiler session is active: spans record."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A context that records the span `name` while a torch.profiler
    session is active, and does nothing else otherwise; inside
    `capturing()`, an entry of the capture's template."""
    rec = getattr(_local, "capture", None)
    if rec is not None:
        return _CaptureSpan(rec, name)
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def capturing():
    """Around the capture of a CUDA graph: the spans opened on this thread
    inside make the `Captured` template it yields, whether or not a
    profiler is active."""
    rec = Captured()
    before = getattr(_local, "capture", None)
    _local.capture = rec
    try:
        yield rec
    finally:
        _local.capture = before


@contextlib.contextmanager
def replaying(name: str, captured: Captured):
    """The span `name` around a replay of the graph whose capture made
    `captured`; while a profiler is active, the template's spans are
    recorded as its children when the body returns."""
    with span(name) as outer:
        yield
        if outer is not None:
            captured.emit(outer)


def spanned(name: str):
    """Decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def spans() -> list[dict]:
    """The recorded spans, oldest first; a span still open has end_ns,
    launches and stream_ms None.  Reading a span's stream time waits for
    its end event."""
    with _lock:
        kept = list(_spans)
    return [s.record() for s in kept]


def dropped() -> int:
    """Spans not recorded because MAX_SPANS were kept."""
    return _dropped


def clear() -> None:
    """Forget the recorded spans and the dropped count."""
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler scope over the host and, where there is a card, its
    kernels; the trace is written under logdir for TensorBoard's profiler
    plugin (or chrome://tracing), and the program's spans recorded inside
    the scope to logdir/program_spans.json."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    first, dropped_before = next(_ids), _dropped
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        try:
            yield
        finally:
            _sync()
    seen = [s for s in spans() if s["id"] > first]
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, SPANS_FILE), "w") as f:
        json.dump({"dropped": _dropped - dropped_before, "spans": seen}, f)
