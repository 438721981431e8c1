"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

prints, as the last line of its standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics untraced, its
per-layer metrics traced), device, with tracing the breakdown, and last the
checks, each compared number beside its limit; the checks are also the
last lines of its standard error.  It exits with another code than 0, and
prints no result, when there is no card or too few, when the program is
missing, or when JAX or the JAX package is loaded in the process.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:1] = [str(HERE), str(HERE.parent)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import harness

    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_PROCESS)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: {', '.join(loaded)} loaded in the benchmark's "
              "process; no result", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
