"""The port's benchmark: one cell, one run.

Everything that belongs to one configuration, cell or metric is a file of
its own, found by the name `BENCHMARK.json` gives it:

  portbench/configs/<config>.json   the deployment: source, guarantees,
                                    what was assumed
  portbench/configs/<config>.py     its driver: makes the inputs from the
                                    seed, makes the timed call into the
                                    program, and judges the answers against
                                    the plain reference (`reference/`)
  portbench/workloads/<cell>.json   the cell's traffic: sizes, distinct
                                    inputs cycled, calls traced
  portbench/metrics/<metric>.py     `read(run)`: one metric from the run's
                                    host-clock calls or its trace, or None
                                    where there is nothing to read; a
                                    metric `<quantity>.<group>` without a
                                    file of its own is read by
                                    `metrics/<quantity>.py`

A run: set-up (imports, the card, the driver's inputs, warm-up calls of
the cell's own shapes), then a closed loop of timed calls for `seconds`
(and at least once over every distinct input), then the check of every
answer of the window against the reference.  With tracing, the profiler
records the device over a few calls after the first, and the run reports
the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import devtrace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bls12_381_tpu")


class Bench:
    """BENCHMARK.json and the files it names, under `root`."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.spec["paths"][0]

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, cell: str) -> dict:
        data = json.loads((self.dir / "workloads" / f"{cell}.json")
                          .read_text())
        w = self.workload(cell)
        if (data["config"], data["traffic"]) != (w["config"], w["traffic"]):
            raise ValueError(f"workloads/{cell}.json names "
                             f"{data['config']}/{data['traffic']}, "
                             f"BENCHMARK.json {w['config']}/{w['traffic']}")
        return data["params"]

    def driver_module(self, config: str):
        return load_module(self.dir / "configs" / f"{config}.py",
                           f"portbench_config_{config}")

    def metric_reader(self, name: str):
        """The reader `metrics/<name>.py`; for a name `<quantity>.<group>`
        with no file of its own, `metrics/<quantity>.py`: one reader serves
        a quantity for every group of cells (each group moving its own
        end-to-end metric)."""
        path = self.dir / "metrics" / f"{name}.py"
        if not path.exists():
            path = self.dir / "metrics" / f"{name.split('.')[0]}.py"
        return load_module(path, f"portbench_metric_{path.stem}").read

    def metrics_of(self, cell: str, traced: bool) -> list[dict]:
        """The end-to-end metrics a cell reports untraced, or the per-layer
        ones it reports traced."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not traced:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Run:
    """What the metric readers read: set-up seconds, the window's calls
    (start, end, work) on the host clock, the cell's traffic, and the trace
    (None untraced)."""
    setup_s: float
    calls: list
    traffic: dict
    trace: devtrace.Trace | None = None


def window(driver, seconds: float, profiler=None, trace_calls: int = 0):
    """The closed loop: call after call until `seconds` have passed and
    every distinct input has been called once.  Returns (calls, answers,
    trace); with a profiler, calls 1 to trace_calls are traced."""
    calls, answers, trace = [], [], None
    spans = driver.spans
    t_start = time.perf_counter()
    i = 0
    while (time.perf_counter() - t_start < seconds
           or i < driver.distinct_inputs):
        if profiler is not None and i == 1:
            profiler.start()
            spans.on, t_trace = True, time.time()
        t0 = time.perf_counter()
        answer, work = driver.call(i)
        t1 = time.perf_counter()
        calls.append((t0, t1, work))
        answers.append((i, answer))
        if profiler is not None and i == trace_calls:
            t_end = time.time()
            spans.on = False
            events = profiler.stop()
            trace = devtrace.Trace(events, spans.spans, trace_calls,
                                   t_trace, t_end)
        i += 1
    if profiler is not None and trace is None:
        raise RuntimeError(f"the window ran {i} calls, fewer than the "
                           f"{trace_calls} + 1 that tracing needs")
    return calls, answers, trace


def device_info(chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips))}


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else f"nvidia-smi failed: {out.stderr.strip()}"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell: str, seed: int, seconds: float, traced: bool, t_process: float,
        device="cuda", root: Path = ROOT) -> dict:
    """One run of a cell; returns the result line's object.  t_process is
    the perf_counter reading at the start of the process."""
    bench = Bench(root)
    w = bench.workload(cell)
    traffic = bench.traffic(cell)
    cfg = bench.config(w["config"])
    mod = bench.driver_module(w["config"])
    on_card = device != "cpu"
    if on_card:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("torch.cuda.is_available() is false: the "
                             "benchmark runs on a card")
        if torch.cuda.device_count() < w["chips"]:
            raise SystemExit(f"cell {cell} needs {w['chips']} cards, "
                             f"{torch.cuda.device_count()} present")
    driver = mod.Driver(cfg, traffic, seed, device)
    marks = [("start", 0.0), ("imports", time.perf_counter() - t_process)]
    driver.setup()
    marks.append(("inputs", time.perf_counter() - t_process))
    for i in range(traffic.get("warmup_calls", 2)):
        driver.call(i)
    profiler = None
    if traced:
        profiler = devtrace.Profiler()
        profiler.warm()
    if on_card:
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter() - t_process))
    print("set-up seconds: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])),
        file=sys.stderr, flush=True)
    # what set-up left is never garbage in the window: the collector need
    # not walk it there
    gc.collect()
    gc.freeze()
    if on_card:
        # the window's peak: what set-up alone used (signing, the scan that
        # makes the points) is not the cell's memory in use
        for d in range(w["chips"]):
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t_process

    calls, answers, trace = window(driver, seconds, profiler,
                                   traffic.get("trace_calls", 4))

    device_obj = device_info(w["chips"]) if on_card else None
    if device_obj is not None:
        if trace is not None:
            device_obj["busy_s"] = trace.busy_s()
            device_obj["window_s"] = trace.window_s
        device_obj["power_limit"] = power_limit()
    ref_inputs = driver.reference_inputs()
    driver.release()
    checks, failed_calls = mod.check(ref_inputs, answers, seed)

    r = Run(setup_s, calls, traffic, trace)
    metrics = {}
    for m in bench.metrics_of(cell, traced):
        value = bench.metric_reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(v <= lim for v, lim in checks.values())
    out = {"correct": correct, "attempted": len(calls),
           "failed": len(failed_calls),
           "metrics": metrics, "device": device_obj}
    if trace is not None:
        out["breakdown"] = devtrace.breakdown(trace)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out
