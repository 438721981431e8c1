"""Build and load the CUDA kernels of `kernels/csrc/`.

Each `.cu` source is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface and loaded with `ctypes` (no PyTorch headers,
so a build takes seconds).  Libraries are built at first use into `_build/`
(listed in `.gitignore`), named by a hash of the sources and flags, so a fresh
checkout builds everything it runs and a changed source is rebuilt.
`build_all()` starts one `nvcc` per source, all at once.  The build log holds
`ptxas -v`'s registers, shared memory and spills for each kernel.

`build_host()` builds the port's host C++ (`utils/csrc/`, no device code)
the same way with the host compiler: `$CXX`, else `c++`, else `g++`.  Its
flags leave out `-march=native`, so a library built on one host loads on
another; its key also names the compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("mont", "plan_exec", "fr", "sha256", "keccak")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def cxx_command() -> list[str]:
    """The host C++ compiler: `$CXX` (split as a shell would), else `c++`,
    else `g++`."""
    if os.environ.get("CXX"):
        return shlex.split(os.environ["CXX"])
    found = shutil.which("c++") or shutil.which("g++")
    if found is None:
        raise RuntimeError("no host C++ compiler (set CXX, or put c++ or g++ "
                           "on PATH)")
    return [found]


def _key(flags, paths) -> str:
    h = hashlib.sha256()
    h.update(" ".join(flags).encode())
    for path in paths:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def lib_path(stem: str) -> Path:
    key = _key(NVCC_FLAGS,
               sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"])
    return BUILD_DIR / f"lib{stem}-{key}.so"


def log_path(stem: str) -> Path:
    return lib_path(stem).with_suffix(".log")


def build_all(stems=SOURCES) -> dict[str, float]:
    """Compile every stale library, one nvcc process per source, all started
    together.  Returns the seconds each build took (0.0 when up to date);
    raises with the compiler's log when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    for stem in stems:
        out = lib_path(stem)
        if out.exists():
            seconds[stem] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for stem, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[stem] = time.perf_counter() - t0
        log_path(stem).write_text(log)
        if proc.returncode != 0:
            failed.append(f"{stem} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def build_host(source: Path) -> Path:
    """The shared library of a host C++ source, compiled first if stale
    (keyed by the compiler, HOST_CXX_FLAGS and the source).  Raises
    RuntimeError with the compiler's output when the build fails."""
    cmd = cxx_command()
    key = _key([*cmd, *HOST_CXX_FLAGS], [source])
    out = BUILD_DIR / f"lib{source.stem}-{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run([*cmd, *HOST_CXX_FLAGS, "-o", str(tmp),
                              str(source)], capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"host build of {source.name} failed: {exc}") \
            from exc
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"host build of {source.name} failed ({shlex.join(cmd)} exit "
            f"{res.returncode}):\n{res.stderr}{res.stdout}")
    os.replace(tmp, out)
    return out


def ptxas_report(stem: str) -> list[str]:
    """The `ptxas -v` lines of a built library: registers, shared memory
    and spill stores/loads per kernel."""
    path = log_path(stem)
    if not path.exists():
        return []
    keep = ("Compiling entry", "registers", "spill")
    return [ln.strip() for ln in path.read_text().splitlines()
            if any(k in ln for k in keep)]


def load(stem: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for a source, built first if stale.  signatures
    maps each C function to its argtypes; every function returns int (the
    launch's cudaGetLastError())."""
    lib = _LOADED.get(stem)
    if lib is None:
        build_all((stem,))
        lib = ctypes.CDLL(str(lib_path(stem)))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LOADED[stem] = lib
    return lib
