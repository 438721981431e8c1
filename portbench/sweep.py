"""Runs of the benchmark one after another, each a process of its own as
the check makes them, for measuring spreads and trying cells on the chip.

    python3 portbench/sweep.py --out <dir> RUN [RUN ...]

where each RUN is `cell,seed,seconds,trace`.  Each run's standard output
and error go to <dir>/<k>_<cell>_<seed>_<trace>.{out,err}; one summary
line a run (exit code, wall seconds, correct, metrics, checks) is printed
and appended to <dir>/summary.jsonl; at the end, for each cell and metric
of three runs or more, the median and the quartile spread (`stats.spread`,
the benchmark's rule for bounds).
"""

import argparse
import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import stats  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    values = collections.defaultdict(list)
    for k, spec in enumerate(args.runs):
        cell, seed, seconds, trace = spec.split(",")
        stem = out / f"{k:02d}_{cell}_{seed}_{trace}"
        cmd = [sys.executable, str(HERE / "run.py"), "--workload", cell,
               "--seed", seed, "--seconds", seconds, "--trace", trace]
        t0 = time.perf_counter()
        with open(f"{stem}.out", "w") as fo, open(f"{stem}.err", "w") as fe:
            try:
                rc = subprocess.run(cmd, stdout=fo, stderr=fe,
                                    timeout=args.timeout).returncode
            except subprocess.TimeoutExpired:
                rc = 124
        wall = time.perf_counter() - t0
        lines = Path(f"{stem}.out").read_text().strip().splitlines()
        try:
            res = json.loads(lines[-1]) if lines else {}
        except json.JSONDecodeError:
            res = {}
        row = {"k": k, "cell": cell, "seed": int(seed), "trace": int(trace),
               "rc": rc, "wall_s": wall, "correct": res.get("correct"),
               "attempted": res.get("attempted"),
               "metrics": {n: m["value"]
                           for n, m in res.get("metrics", {}).items()},
               "device": res.get("device"), "checks": res.get("checks"),
               "breakdown": res.get("breakdown")}
        print(json.dumps(row), flush=True)
        for name, value in row["metrics"].items():
            values[cell, name].append(value)
        with open(out / "summary.jsonl", "a") as f:
            f.write(json.dumps(row) + "\n")
        if rc != 0:
            err = Path(f"{stem}.err").read_text()
            print(err[-3000:], file=sys.stderr, flush=True)
    for (cell, name), v in values.items():
        if len(v) >= 3:
            print(f"{cell} {name}: {len(v)} runs, median "
                  f"{statistics.median(v)!r}, spread {stats.spread(v)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
