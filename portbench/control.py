"""The controls of the benchmark's checks: a cell run with the guarantee
its configuration states broken, which the checks must call not correct.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        --seconds <s> [--device cuda]

`kzg_commit_g1` commits to the scalars cut to their low 253 bits;
`eth_bls_verify` leaves the pairing comparison out (a set verifies when its
points parse).  Each seed is a set-up, a window of `seconds` at the cell's
own size and load, and the check; one JSON line a seed gives the compared
numbers, each beside its limit.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:1] = [str(HERE), str(HERE.parent)]


def control_run(cell: str, seed: int, seconds: float, device="cuda",
                root=None) -> dict:
    import harness

    bench = harness.Bench(root or harness.ROOT)
    w = bench.workload(cell)
    traffic = bench.traffic(cell)
    mod = bench.driver_module(w["config"])
    driver = mod.Driver(bench.config(w["config"]), traffic, seed, device,
                        control=True)
    driver.setup()
    calls, answers, _ = harness.window(driver, seconds)
    ref_inputs = driver.reference_inputs()
    driver.release()
    checks, failed = mod.check(ref_inputs, answers, seed)
    return {"workload": cell, "seed": seed, "attempted": len(calls),
            "failed": len(failed),
            "correct": all(v <= lim for v, lim in checks.values()),
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control_run(args.workload, seed, args.seconds,
                                     args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
