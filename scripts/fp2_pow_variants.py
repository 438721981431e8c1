#!/usr/bin/env python3
"""Time variants of the Fp2 power kernel that the library does not build.

Run from the root of a checkout on a machine with a CUDA device:

    python3 scripts/fp2_pow_variants.py

`csrc/fp2_pow.cuh`'s design note says what its launch shape and its
Montgomery product buy; this script measures it.  For each variant it copies
`bls12_381_torch/kernels/csrc/` into `kernels/_build/variants/<name>/`
(git-ignored), rewrites that copy of `fp2_pow.cuh`, and builds its
`mont.cu` with the library's nvcc flags, one nvcc per variant, all started
together.  The variants:

- `lanes=N`: N lanes per block (2N threads) in place of `kLanes`, for the
  other two of 32, 64 and 128;
- `u64`: `mont_sum` computed by `montgomery.cuh`'s `mul_acc` and
  `mont_reduce` (64-bit carries, one conditional subtraction each), the
  Fp power's product: design step 1 without steps 2 and 3.

It then launches each variant's `bls_fp2_pow_fixed` and the library's,
through `mont.fp2_pow_fixed`'s launch code, at (p-1)/2 on the same random canonical operands at
1, 1024 and 2^16 lanes, and prints one JSON line per variant and width:
device ms per launch (CUDA events around LAUNCHES back-to-back launches,
the median of REPS rounds that take the variants in turn), whether every
lane equals the library's, and the variant's registers and spill bytes from
`ptxas -v`.  It imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WIDTHS = (1, 1024, 1 << 16)
LAUNCHES = 20
REPS = 3
# mont_sum's opening line, where the u64 variant's body goes in first
MONT_SUM_OPEN = "                                         uint32_t (&r)[W]) {\n"
U64_BODY = """  {
    uint32_t t[2 * W + 1];
    montgomery::zero_wide(t);
    montgomery::mul_acc(t, x1, y1);
    if (kTwo) montgomery::mul_acc(t, x2, y2);
    montgomery::mont_reduce<fp384::Field>(t, r);
    return;
  }
"""


def variants(lanes: int) -> dict[str, tuple[str, str]]:
    """name -> (text of fp2_pow.cuh to replace, its replacement)."""
    own = f"constexpr int kLanes = {lanes};"
    out = {f"lanes={n}": (own, f"constexpr int kLanes = {n};")
           for n in (32, 64, 128) if n != lanes}
    out["u64"] = (MONT_SUM_OPEN, MONT_SUM_OPEN + U64_BODY)
    return out


def build(name: str, old: str, new: str, csrc: Path, flags, nvcc: str,
          root: Path):
    """Copy the sources, rewrite fp2_pow.cuh, start nvcc: (process, lib)."""
    out = root / name.replace("=", "")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    header = out / "fp2_pow.cuh"
    text = header.read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"{name}: fp2_pow.cuh does not hold {old!r} once")
    header.write_text(text.replace(old, new))
    lib = out / "libmont.so"
    cmd = [nvcc, *flags, "-o", str(lib), str(out / "mont.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def ptxas(log: str) -> tuple[int | None, int | None]:
    """(registers, spill store + load bytes) of fp2_pow_kernel."""
    regs = spills = None
    mine = False
    for line in log.splitlines():
        if "Compiling entry" in line:
            mine = "fp2_pow_kernel" in line
        elif mine and (m := re.search(r"Used (\d+) registers", line)):
            regs = int(m[1])
        elif mine and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            spills = int(m[1]) + int(m[2])
    return regs, spills


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("fp2_pow_variants: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from bls12_381_torch import limbs, params
    from bls12_381_torch.kernels import build as kbuild
    from bls12_381_torch.kernels import mont

    root = kbuild.BUILD_DIR / "variants"
    procs = {name: build(name, old, new, kbuild.CSRC, kbuild.NVCC_FLAGS,
                         kbuild.nvcc_path(), root)
             for name, (old, new) in variants(mont.FP2_POW_LANES).items()}
    fns, usage = {}, {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"fp2_pow_variants: {name} failed to build:\n{log}")
        fn = ctypes.CDLL(str(lib)).bls_fp2_pow_fixed
        fn.argtypes = list(mont._SIGNATURES["bls_fp2_pow_fixed"])
        fn.restype = ctypes.c_int
        fns[name], usage[name] = fn, ptxas(log)

    def launcher(fn):
        return lambda a0, a1, e: mont._pow_launch(
            lambda: fn, limbs.FP, [a0, a1], e, "fp2_pow_fixed")

    library = f"library lanes={mont.FP2_POW_LANES}"
    calls = {library: launcher(mont._lib().bls_fp2_pow_fixed),
             **{name: launcher(fn) for name, fn in fns.items()}}
    usage[library] = ptxas("\n".join(kbuild.ptxas_report("mont")))
    e = (params.P - 1) // 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ok = True
    for B in WIDTHS:
        a = torch.randint(0, 1 << 16, (2, 24, B), generator=gen,
                          device="cuda", dtype=torch.int32)
        a[:, 23] %= limbs.FP.p_limbs[23]  # canonical: below p
        want = calls[library](a[0], a[1], e)
        equal = {name: bool(torch.equal(call(a[0], a[1], e), want))
                 for name, call in calls.items()}
        ok &= all(equal.values())
        ms = {name: [] for name in calls}
        for _ in range(REPS):
            for name, call in calls.items():
                start.record()
                for _ in range(LAUNCHES):
                    call(a[0], a[1], e)
                end.record()
                end.synchronize()
                ms[name].append(start.elapsed_time(end) / LAUNCHES)
        for name in calls:
            regs, spills = usage[name]
            print(json.dumps({
                "variant": name, "exponent": "(p-1)/2", "B": B,
                "ms": statistics.median(ms[name]), "ms_reps": ms[name],
                "equal": equal[name], "registers": regs,
                "spill_bytes": spills}), flush=True)
    if not ok:
        sys.exit("fp2_pow_variants: a variant disagrees with the library")


if __name__ == "__main__":
    main()
