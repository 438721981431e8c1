"""The traced part of a run: device events from `torch.profiler`, the host
spans the drivers record around their calls into the program, and the
per-layer quantities the metric readers take from them.

Only device activity is traced (tracing every torch op on the host as well
gives the same device events and slows the host-bound paths several
times).  The profiler stamps device events on the host's wall clock
(`time.time_ns`), the clock the spans use, so an idle gap on the device
can be named by the span the host was in.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import re
import time

import stats

# The program's own CUDA kernels (`bls12_381_torch/kernels/csrc/`), frozen
# here so that the split between its kernels and torch's cannot move with
# the program; a later kernel joins the list in a benchmark change.
PORT_KERNELS = ("plan_kernel", "sop_rows_kernel", "sqr_kernel",
                "mont_pow_kernel", "fp2_pow_kernel", "butterfly_kernel",
                "sha256_kernel", "xmd_sha256_kernel", "shake_kernel")
_PORT_RE = re.compile(r"\b(" + "|".join(PORT_KERNELS) + r")\b")
NOT_LAUNCHES = ("Memcpy", "Memset")
NAME_CHARS = 96


def is_port_kernel(name: str) -> bool:
    return _PORT_RE.search(name) is not None


def is_launch(name: str) -> bool:
    return not name.startswith(NOT_LAUNCHES)


def short_name(name: str) -> str:
    """A kernel's name without `void `, anonymous namespaces and its
    parameter list, cut to NAME_CHARS characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:NAME_CHARS].strip()


class Spans:
    """Host spans (name, start_s, end_s) on the wall clock, recorded only
    while on; `span(name)` is a no-op otherwise."""

    def __init__(self):
        self.on = False
        self.spans: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0 * 1e-9, time.time_ns() * 1e-9))


@dataclasses.dataclass
class Trace:
    """What a traced run read: device events (name, start_s, end_s), the
    host spans, the traced calls' count and their host-clock window."""
    events: list
    spans: list
    calls: int
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        return stats.busy_seconds((s, e) for _, s, e in self.events)


class Profiler:
    """torch.profiler over device activity, started and stopped around the
    traced calls; `warm()` runs it once empty in set-up, so that the
    tracer's own start-up is not in the window."""

    def __init__(self):
        self._prof = None

    def warm(self) -> None:
        self.start()
        self.stop()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self) -> list:
        """Stop and return the device events (name, start_s, end_s)."""
        import torch

        torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        events = _device_events(prof)
        # the profiler's records are cyclic garbage: collect them now, not
        # inside a later timed call
        del prof
        gc.collect()
        return events


def _device_events(prof) -> list:
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        start = ev.start_ns() if hasattr(ev, "start_ns") else \
            ev.start_us() * 1000
        dur = ev.duration_ns() if hasattr(ev, "duration_ns") else \
            ev.duration_us() * 1000
        out.append((ev.name(), start * 1e-9, (start + dur) * 1e-9))
    return out


# ---------------------------------------------------------------------------
# per-layer quantities, per traced call
# ---------------------------------------------------------------------------


def launches_per_call(trace: Trace) -> float | None:
    n = sum(1 for name, _, _ in trace.events if is_launch(name))
    return n / trace.calls if n else None


def port_kernel_s(trace: Trace) -> float:
    return sum(e - s for name, s, e in trace.events if is_port_kernel(name))


def port_kernel_ms_per_call(trace: Trace) -> float | None:
    t = port_kernel_s(trace)
    return 1e3 * t / trace.calls if t > 0 else None


def glue_device_ms_per_call(trace: Trace) -> float | None:
    t = sum(e - s for name, s, e in trace.events if not is_port_kernel(name))
    return 1e3 * t / trace.calls if t > 0 else None


def device_idle_share(trace: Trace) -> float | None:
    if not trace.events or trace.window_s <= 0:
        return None
    return 1.0 - trace.busy_s() / trace.window_s


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the traced window
    (seconds summed by name), and where the device sat idle: the idle
    seconds summed by the host span that covers most of each gap, with the
    count of gaps and the longest."""
    by_name: dict[str, float] = {}
    for name, s, e in trace.events:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle: dict[str, list] = {}
    for a, b in stats.idle_gaps([(s, e) for _, s, e in trace.events],
                                trace.start, trace.end):
        acc = idle.setdefault(host_span_over(trace.spans, a, b),
                              [0.0, 0, 0.0])
        acc[0] += b - a
        acc[1] += 1
        acc[2] = max(acc[2], b - a)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_ops": [[n, t] for n, t in ops],
            "idle_gaps": [[f"{n}: {k} gaps, longest {longest:.6f} s", t]
                          for n, (t, k, longest) in gaps]}


def host_span_over(spans, a: float, b: float) -> str:
    """The host span that covers most of [a, b], or "between calls"."""
    best, most = "between calls", 0.0
    for name, s, e in spans:
        overlap = min(b, e) - max(a, s)
        if overlap > most:
            best, most = name, overlap
    return best
