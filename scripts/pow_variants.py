#!/usr/bin/env python3
"""Time the Fp and Fr power kernel's launch shapes that the library does
not build, beside the library's and, given a parent tree, the parent's.

Run from the root of a checkout on a machine with a CUDA device:

    python3 scripts/pow_variants.py [--parent DIR] [--check] [--widths B ...]

`csrc/mont_pow.cuh` says what its threads per lane (kTpi) and lanes per
block (kLanes) buy; this script measures them.  It writes one small source
per field into `kernels/_build/variants/pow/` (git-ignored), each
including `mont_pow.cuh` and launching `mont_pow_kernel<F, T, L>` at every
(threads per lane, lanes per block) of VARIANTS, and builds them with the
library's nvcc flags, all nvcc processes started together.  With
`--parent DIR` (a checkout of the parent commit, e.g. unpacked by `git
archive`) it also builds that tree's `mont.cu` and `fr.cu` and times
their `bls_pow_fixed` and `bls_pow_fixed_fr`.

Rows: Fp at p - 2 and Fr at q - 2, at WIDTHS lanes, on the same random
canonical operands (chip_smoke.pow_operand's edge lanes among them).  One
JSON line per kernel and width: device ms per launch (the mean duration of
LAUNCHES launches' kernel events under torch.profiler,
`chip_smoke.device_events`, the median of REPS rounds that take the
kernels in turn), whether every lane equals the library's (the library's
equals the plain version in the `gpu` tests), the bound (`chip_smoke.
pow_work`); first, registers and spill bytes from `ptxas -v` and, from
`cuobjdump -sass`, the instructions of each of the library's instances
(one per threads per lane it launches) and of the parent's kernel.
`--check`: equality only, no timing; `--widths`: other widths than
WIDTHS.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WIDTHS = (1, 1024, 1 << 16)
LAUNCHES = 10
REPS = 3
# (threads per lane, lanes per block)
VARIANTS = ((1, 32), (1, 128), (2, 16), (2, 32), (2, 64), (4, 16), (4, 32))

SOURCE = """#include "{header}"
#include "mont_pow.cuh"

// (threads per lane, lanes per block) of VARIANTS; else an invalid value
extern "C" int bls_pow_variant(const void* a, void* out, const uint8_t* d,
                               int nd, int B, int tpi, int lanes,
                               void* stream) {{
{cases}
  return (int)cudaErrorInvalidValue;
}}
"""
CASE = ("  if (tpi == {t} && lanes == {l})\n"
        "    return montpow::launch_pow_shape<{field}::Field, {t}, {l}>(\n"
        "        a, out, d, nd, B, stream);")
# field: (its header, the library's C function and source, the wrapper)
FIELDS = {"fp": ("fp384", "bls_pow_fixed", "mont", "pow_fixed"),
          "fr": ("fr256", "bls_pow_fixed_fr", "fr", "pow_fixed_fr")}


def main() -> None:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the parent commit to time beside")
    ap.add_argument("--check", action="store_true",
                    help="equality with the library only, no timing")
    ap.add_argument("--widths", type=int, nargs="+", default=WIDTHS,
                    help="lanes per launch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("pow_variants: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke
    from xmd_sqr_variants import ptxas, sass_counts, start_build

    from bls12_381_torch import limbs, params
    from bls12_381_torch.kernels import build as kbuild
    from bls12_381_torch.kernels import mont

    root = kbuild.BUILD_DIR / "variants" / "pow"
    root.mkdir(parents=True, exist_ok=True)
    csrc, flags, nvcc = kbuild.CSRC, kbuild.NVCC_FLAGS, kbuild.nvcc_path()
    jobs = {}
    for name, (field, *_) in FIELDS.items():
        cases = "\n".join(CASE.format(t=t, l=lanes, field=field)
                          for t, lanes in VARIANTS)
        src = root / f"pow_{name}.cu"
        src.write_text(SOURCE.format(header=f"{field}.cuh", cases=cases))
        lib = root / f"libpow_{name}.so"
        jobs[name] = (start_build(src, lib, csrc, flags, nvcc), lib)
    if args.parent is not None:
        pcsrc = args.parent / "bls12_381_torch" / "kernels" / "csrc"
        for name, (_, _, stem, _) in FIELDS.items():
            lib = root / f"libparent_{stem}.so"
            jobs[f"parent_{name}"] = (start_build(
                pcsrc / f"{stem}.cu", lib, pcsrc, flags, nvcc), lib)
    kbuild.build_all(("mont", "fr"))
    libs, logs = {}, {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"pow_variants: {name} failed to build:\n{log}")
        libs[name], logs[name] = ctypes.CDLL(str(lib)), log
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in FIELDS:
        libs[name].bls_pow_variant.argtypes = (P, P, P, I, I, I, I, P)
        if f"parent_{name}" in libs:
            fn = getattr(libs[f"parent_{name}"], FIELDS[name][1])
            fn.argtypes = mont._POW_ARGS
    usage = {name: ptxas(log, "10pow_kernel" if name.startswith("parent")
                         else "mont_pow_kernel")
             for name, log in logs.items()}
    usage["library"] = {stem: ptxas("\n".join(kbuild.ptxas_report(stem)),
                                    "mont_pow_kernel")
                        for stem in ("mont", "fr")}
    print(json.dumps({"ptxas": usage}), flush=True)
    sass = {}
    for name, (field, _, stem, _) in FIELDS.items():
        for t in (mont.POW_TPI if name == "fp" else mont.POW_TPI_FR, 2, 1):
            sass[f"library {name} tpi={t}"] = (
                kbuild.lib_path(stem),
                f"mont_pow_kernelIN{len(field)}{field}5FieldELi{t}ELi"
                f"{mont.POW_LANES}E")
    for name in FIELDS:
        if f"parent_{name}" in libs:
            sass[f"parent {name}"] = (jobs[f"parent_{name}"][1],
                                      "10pow_kernel")
    for name, (lib, fun) in sass.items():
        print(json.dumps({"sass": name, **sass_counts(lib, fun)}),
              flush=True)

    def launcher(fn, *extra):
        def call(spec, a, e):
            return mont._pow_launch(
                lambda: lambda *xs: fn(*xs[:-1], *extra, xs[-1]), spec, [a],
                e, "pow_fixed" if spec is limbs.FP else "pow_fixed_fr")[0]
        return call

    calls = {}
    for name, (_, symbol, _, wrapper) in FIELDS.items():
        calls[name] = {"library": lambda spec, a, e, w=wrapper: getattr(
            mont, w)(a, e)}
        for t, lanes in VARIANTS:
            calls[name][f"tpi={t} lanes={lanes}"] = launcher(
                libs[name].bls_pow_variant, t, lanes)
        if f"parent_{name}" in libs:
            calls[name]["parent"] = launcher(
                getattr(libs[f"parent_{name}"], symbol))

    def timed(fns):
        """Per call: device ms per launch (the mean duration of its
        pow kernel's events under torch.profiler, LAUNCHES launches) in
        each of REPS rounds that take the calls in turn; a capture that
        falls short of LAUNCHES events is taken again, up to three times."""
        ms = {name: [] for name in fns}
        for _ in range(REPS):
            for name, fn in fns.items():
                fn()
                for _ in range(3):
                    evs = chip_smoke.device_events(
                        lambda fn=fn: [fn() for _ in range(LAUNCHES)])
                    durs = [e - s for n, s, e in evs if "pow_kernel" in n]
                    if len(durs) == LAUNCHES:
                        break
                else:
                    sys.exit(f"pow_variants: {name}: {len(durs)} pow "
                             f"events for {LAUNCHES} launches")
                ms[name].append(statistics.mean(durs) / 1e3)
        return ms

    ok = True
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    for name, spec, label, e in (("fp", limbs.FP, "p-2", params.P - 2),
                                 ("fr", limbs.FR, "q-2", params.Q - 2)):
        for B in args.widths:
            a = chip_smoke.pow_operand(spec, B, gen, "cuda")
            want = calls[name]["library"](spec, a, e)
            equal = {v: bool(torch.equal(c(spec, a, e), want))
                     for v, c in calls[name].items()}
            ok &= all(equal.values())
            ms = {v: [None] for v in calls[name]} if args.check else timed(
                {v: (lambda c=c: c(spec, a, e))
                 for v, c in calls[name].items()})
            bound_ms, by = chip_smoke.bound(*chip_smoke.pow_work(spec, e, B))
            for v in calls[name]:
                print(json.dumps({
                    "kernel": FIELDS[name][1], "variant": v,
                    "exponent": label, "B": B,
                    "ms": None if args.check else statistics.median(ms[v]),
                    "ms_reps": ms[v], "equal": equal[v],
                    "bound_ms": bound_ms, "bound_by": by}), flush=True)
    if not ok:
        sys.exit("pow_variants: a variant disagrees with the library")


if __name__ == "__main__":
    main()
