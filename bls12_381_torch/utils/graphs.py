"""Replay of a fixed launch sequence from a CUDA graph per shape, and the
one budget on the graphs' memory that every public path of the port keeps.

A body whose launch sequence is fixed by its inputs' shapes and a few
arguments, and which reads nothing back to the host, runs on a card from
a CUDA graph per shape (`graphed`; the MSM of `ops/msm.py`): the first
call at a shape runs eagerly (it warms the libraries, the cached
constants and the allocator), the second captures the body on static
copies of its inputs and replays it, and every later call copies its
inputs in, replays, and returns a copy of the graph's output.  CPU tensors
never capture: they run the body as written.  A capture that raises
leaves its shape eager, counted in `kernels.GRAPHS.fallbacks`.

The graphs are a cache, each with a private memory pool of about the
eager call's peak, under one budget: at most SLOTS shapes, and pools
(static inputs included) of at most POOL_SHARE of the card's memory.  A
new graph drops the least recently used ones until both hold; a graph
that alone exceeds the budget is replayed once and not kept, and its
shape runs eagerly after (`GRAPHS.oversize`).  Every public path that
runs on the card (`releasing`, and `graphed` itself) gives the pools back
when it runs out of device memory while graphs are kept: it drops them
all and runs once more.

Calls at a shape take one lock on the host.  On the device a replay first
waits for the previous replay of its graph to be read out (an event
recorded after the copy of its output), so callers on several streams are
ordered too.  A replay under a profiler is the span `name`, with the
capture's spans as its children (`profiling.replaying`).
"""

from __future__ import annotations

import collections
import functools
import threading

import torch

from ..kernels import BUCKETS, GRAPHS, LAUNCHES
from . import profiling, scans

SLOTS = 4  # shapes whose state (graph, or calls seen) is kept
POOL_SHARE = 1 / 8  # of a card's memory: the most its kept graphs hold


def _replayed() -> tuple:
    """The counters a replay adds as its capture counted them."""
    return LAUNCHES, BUCKETS


class _Graph:
    """One shape's capture: the graph, its static inputs and output, the
    capture's span template and counts (`_replayed`'s), the bytes it holds,
    its device, and the event after the last read of its output."""
    __slots__ = ("graph", "inputs", "output", "spans", "launches", "nbytes",
                 "device", "done", "__weakref__")

    def __init__(self, graph, inputs, output, spans, launches, nbytes,
                 device):
        self.graph, self.inputs, self.output = graph, inputs, output
        self.spans, self.launches = spans, launches
        self.nbytes, self.device = nbytes, device
        self.done = torch.cuda.Event() if graph is not None else None


_SEEN, _EAGER = "seen", "eager"  # called once; capture raised or too large
# shape key -> _SEEN, _EAGER or its _Graph, least recently used first
_graphs: collections.OrderedDict = collections.OrderedDict()
# held over a card call: a shape's state is checked, then changed, and its
# static inputs are written, replayed and read, one caller at a time;
# reentrant, since a call that runs out of memory releases the graphs
_lock = threading.RLock()


def _key(body, inputs, *args) -> tuple:
    """What fixes the launch sequence: the body, each input's shape, dtype
    and device, and the other arguments."""
    return (body, args, tuple((tuple(t.shape), t.dtype, t.device)
                              for t in scans.tree_leaves(inputs)))


def _budget(device) -> int:
    return int(torch.cuda.get_device_properties(device).total_memory
               * POOL_SHARE)


def _held() -> bool:
    return any(isinstance(s, _Graph) for s in _graphs.values())


def _remember(key, state) -> None:
    """`state` as the newest; the least recently used shapes beyond SLOTS
    go, and, for a graph, the older graphs of its card beyond the
    budget."""
    _graphs[key] = state
    _graphs.move_to_end(key)
    while len(_graphs) > SLOTS:
        _graphs.popitem(last=False)
    if not isinstance(state, _Graph):
        return
    mine = [k for k, s in _graphs.items()
            if isinstance(s, _Graph) and s.device == state.device]
    total = sum(_graphs[k].nbytes for k in mine)
    for k in mine[:-1]:
        if total <= _budget(state.device):
            break
        total -= _graphs.pop(k).nbytes


def release() -> None:
    """Drop every kept graph and give its pool back to the card; their
    shapes capture again at their next call."""
    with _lock:
        # no name may hold a graph here: its pool goes only with it
        for key in [k for k, s in _graphs.items() if isinstance(s, _Graph)]:
            _graphs[key] = _SEEN
    torch.cuda.empty_cache()


def _or_release(fn):
    """fn(), and once more with the graphs released where it ran out of
    device memory while graphs were kept; the launch counts of the attempt
    that failed are taken back."""
    if not _held():
        return fn()
    before = [c.snapshot() for c in _replayed()]
    try:
        return fn()
    except torch.OutOfMemoryError:
        for c, snap in zip(_replayed(), before):
            c.restore(snap)
    # out of the handler: the failed attempt's tensors are free
    release()
    return fn()


def releasing(fn):
    """Decorator of a public path that runs on the card: a call that runs
    out of device memory while graphs are kept releases them and runs once
    more."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        return _or_release(lambda: fn(*args, **kwargs))
    call.releases_graphs = True
    return call


def _capture(body, inputs, args) -> _Graph:
    """Capture body(*inputs, *args) on static copies of the inputs, its
    spans as a template; the capture's launches and bucket sums are not
    counted (a replay counts them)."""
    static = scans.tree_map(
        lambda t: t.clone(memory_format=torch.contiguous_format), inputs)
    graph = torch.cuda.CUDAGraph()
    # as torch.cuda.graph does on entry: what is reserved after the capture
    # beyond this is the graph's pool
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    before = [c.snapshot() for c in _replayed()]
    try:
        with profiling.capturing() as spans, torch.cuda.graph(graph):
            out = body(*static, *args)
    finally:
        launches = [c.since(snap) for c, snap in zip(_replayed(), before)]
        for c, snap in zip(_replayed(), before):
            c.restore(snap)
    nbytes = torch.cuda.memory_reserved() - reserved + sum(
        t.nbytes for t in scans.tree_leaves(static))
    return _Graph(graph, static, out, spans, launches, nbytes,
                  torch.cuda.current_device())


def _replay(name: str, g: _Graph, inputs):
    g.done.wait()  # the previous replay's output is read out
    for s, t in zip(scans.tree_leaves(g.inputs), scans.tree_leaves(inputs)):
        s.copy_(t)
    with profiling.replaying(name, g.spans):
        g.graph.replay()
        for c, counts in zip(_replayed(), g.launches):
            c.add(counts)
    GRAPHS.replays += 1
    # the next replay rewrites the output: the caller holds a copy
    out = scans.tree_map(torch.clone, g.output)
    g.done.record()
    return out


def graphed(name: str, body, inputs, *args):
    """body(*inputs, *args), from a CUDA graph of its shape where the inputs
    are CUDA tensors (the module's note), a replay being the span `name`.
    A capture waits for a call with no profiler active (a profiler's own
    work is no part of the graph)."""
    leaves = scans.tree_leaves(inputs)
    if any(t.device.type != "cuda" for t in leaves):
        return body(*inputs, *args)
    key = _key(body, inputs, *args)
    with _lock, torch.cuda.device(leaves[0].device):
        state = _graphs.get(key)
        if isinstance(state, _Graph):
            _graphs.move_to_end(key)
            return _replay(name, state, inputs)
        if state == _SEEN and not profiling.active():
            try:
                g = _or_release(lambda: _capture(body, inputs, args))
            except RuntimeError:
                GRAPHS.fallbacks += 1
                state = _EAGER
            else:
                GRAPHS.captures += 1
                if g.nbytes > _budget(g.device):
                    GRAPHS.oversize += 1
                    _remember(key, _EAGER)
                else:
                    _remember(key, g)
                return _replay(name, g, inputs)
        _remember(key, state or _SEEN)
        GRAPHS.eager += 1
        return _or_release(lambda: body(*inputs, *args))
