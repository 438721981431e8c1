#!/usr/bin/env python3
"""Time the XMD and square kernels' variants that the library does not
build, beside the library's and, given a parent tree, the parent's.

Run from the root of a checkout on a machine with a CUDA device:

    python3 scripts/xmd_sqr_variants.py [--parent DIR]

`csrc/sha256.cu` and `csrc/mont_sqr.cuh` say what their design steps buy;
this script measures them.  It writes two small sources into
`kernels/_build/variants/xmd_sqr/` (git-ignored) and builds them with the
library's nvcc flags, all nvcc processes started together:

- `xmd.cu` includes `sha256.cu` and adds `xmd_variant_kernel`, the
  library's XMD kernel with its design choices as flags (stage a warp's
  b_i in shared memory; take the host's terms of b_i's first block, the
  library's choice; one compression site for every block), launched in
  XMD_VARIANTS' combinations;
- `sqr.cu` includes `mont_sqr.cuh` and launches `sqr_kernel` at 128 and
  256 threads a block and one and two lanes a thread (the library takes
  one shape).

With `--parent DIR` (a checkout of the parent commit, e.g. unpacked by
`git archive`) it also builds that tree's `sha256.cu` and `mont.cu` and
times their `bls_expand_xmd_sha256` (the XMD kernel before this design,
its parameter block packed as that tree's `XmdParams`: midstate, msg_len,
len_in_bytes, ell, len(DST'), DST' in 256 bytes) and `bls_sqr`.

The XMD rows: 32-byte messages to 256 bytes under the bench DST (the G2
hash's shape) at 1, 256 and 2^16 lanes; the square rows: G = 1 at 1024,
2^16 and 2^20 lanes, each launch on the next of enough operand copies to
hold twice the L2 (`chip_smoke.rotating`), so that each reads from HBM.
One JSON line per kernel and width: device ms per launch (the mean
duration of LAUNCHES launches' kernel events under torch.profiler,
`chip_smoke.device_events`, the median of REPS rounds that take the
kernels in turn), whether every lane equals the library kernel's (the
library's equals the plain version in the `gpu` tests); first, registers and
spill bytes from `ptxas -v` and, from `cuobjdump -sass`, the instructions
of the library's XMD and square kernels and the parent's XMD, in all and
by opcode.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import struct
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
XMD_WIDTHS = (1, 256, 1 << 16)
SQR_WIDTHS = (1024, 1 << 16, 1 << 20)
LAUNCHES = 20
REPS = 3
DST = b"BENCH-DST_"  # chip_smoke.HASH_DST
MSG_LEN, OUT_LEN = 32, 256

XMD_SOURCE = """#include "sha256.cu"

namespace {

// A warp's b_i through shared memory, each store instruction 16 lanes' 32
// bytes (full sectors).  Store width 16 only; the other widths store as
// store_b does.
__device__ __forceinline__ void store_b_staged(uint8_t* out,
                                               const uint32_t (&st)[8],
                                               uint32_t off, int lane,
                                               bool live, int B,
                                               const XmdParams& p) {
  __shared__ uint32_t stage[kThreads / 32][32 * 9];
  const int wl = threadIdx.x & 31;
  const uint32_t n = min(32u, p.len_in_bytes - off);
  if (p.store != 16) {
    if (live) store_b(out + (size_t)lane * p.len_in_bytes + off, st, n,
                      p.store);
    return;
  }
  uint32_t* s = stage[threadIdx.x >> 5];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) s[wl * 9 + k] = bswap(st[k]);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = (wl >> 1) + 16 * r, half = wl & 1;
    const int dst_lane = lane - wl + c;
    if (dst_lane < B && 16u * half < n) {
      const uint32_t* q = s + c * 9 + 4 * half;
      *reinterpret_cast<uint4*>(out + (size_t)dst_lane * p.len_in_bytes +
                                off + 16 * half) =
          make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
}

// Write b_i (the state st) at byte `off` of the lane's output row.
template <bool kStage>
__device__ __forceinline__ void store_bi(uint8_t* out,
                                         const uint32_t (&st)[8],
                                         uint32_t off, int lane, bool live,
                                         int B, const XmdParams& p) {
  if (kStage)
    store_b_staged(out, st, off, lane, live, B, p);
  else
    store_b(out + (size_t)lane * p.len_in_bytes + off, st,
            min(32u, p.len_in_bytes - off), p.store);
}

// The library's kernel with its design choices as flags: kStage stores by
// store_b_staged; kSchedule takes the host's terms in b_i's first block
// (the library's choice); kOneCopy sends every block of b0 and of the b_i
// through one compression site, one copy of the unrolled rounds in place
// of three (it cannot take the host's terms, which need that block
// compressed apart).
template <int kLoad, bool kStage, bool kSchedule, bool kOneCopy>
__global__ void __launch_bounds__(kThreads)
xmd_variant_kernel(const uint8_t* __restrict__ msg, uint8_t* __restrict__ out,
                   const __grid_constant__ XmdParams p, int B) {
  static_assert(!(kSchedule && kOneCopy), "kSchedule compresses apart");
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const bool live = lane < B;
  if (!kStage && !live) return;  // the staged stores need the whole warp
  const uint8_t* row = msg + (size_t)(live ? lane : B - 1) * p.msg_len;
  uint32_t b0[8], b[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if constexpr (kOneCopy) {
    // input i (0: b0, then b_1 .. b_ell), its block blk; st its state
    uint32_t st[8], i = 0;
    int blk = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) st[j] = p.midstate[j];
    const int blocks = (int)(p.b0_blocks + p.ell * p.bi_blocks);
    for (int k = 0; k < blocks; ++k) {
      uint32_t w[16];
      if (i == 0) {
        b0_block<kLoad>(row, p, blk, w);
      } else if (blk == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          w[j] = b0[j] ^ b[j], w[8 + j] = p.bi_tail[j];
        w[8] |= i << 24;
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) w[j] = p.bi_tail[16 * blk - 8 + j];
      }
      compress_xmd<false>(st, w, p, 0);
      if (++blk < (int)(i == 0 ? p.b0_blocks : p.bi_blocks)) continue;
      if (i == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) b0[j] = st[j];
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = st[j];
        store_bi<kStage>(out, b, 32 * (i - 1), lane, live, B, p);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) st[j] = kH0[j];
      ++i, blk = 0;
    }
    return;
  }
  // b0 = H(Z_pad || msg || I2OSP(len, 2) || 0x00 || DST')
#pragma unroll
  for (int j = 0; j < 8; ++j) b0[j] = p.midstate[j];
  for (int blk = 0; blk < (int)p.b0_blocks; ++blk) {
    uint32_t w[16];
    b0_block<kLoad>(row, p, blk, w);
    compress_xmd<false>(b0, w, p, 0);
  }
  // b_i = H((b0 ^ b_(i-1)) || I2OSP(i, 1) || DST'), b_0 taken as zero
  for (uint32_t i = 1; i <= p.ell; ++i) {
    const uint32_t i8 = i << 24;
    uint32_t w[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      w[j] = b0[j] ^ b[j];
      w[8 + j] = p.bi_tail[j];
      b[j] = kH0[j];
    }
    w[8] |= i8;
    compress_xmd<kSchedule>(b, w, p, i8);
    for (int blk = 1; blk < (int)p.bi_blocks; ++blk) {
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = p.bi_tail[16 * blk - 8 + j];
      compress_xmd<false>(b, w, p, 0);
    }
    store_bi<kStage>(out, b, 32 * (i - 1), lane, live, B, p);
  }
}

// Launch xmd_variant_kernel<p.load, kStage, kSchedule, kOneCopy>.
template <bool kStage, bool kSchedule, bool kOneCopy>
int launch_xmd(const void* msg, void* out, const void* params, int B,
               void* stream) {
  const XmdParams& p = *(const XmdParams*)params;
  if (!xmd_params_ok(msg, out, p, B)) return (int)cudaErrorInvalidValue;
  const int grid = (B + kThreads - 1) / kThreads;
  const auto s = (cudaStream_t)stream;
  const auto m = (const uint8_t*)msg;
  const auto o = (uint8_t*)out;
  if (p.load == 16)
    xmd_variant_kernel<16, kStage, kSchedule, kOneCopy>
        <<<grid, kThreads, 0, s>>>(m, o, p, B);
  else if (p.load == 4)
    xmd_variant_kernel<4, kStage, kSchedule, kOneCopy>
        <<<grid, kThreads, 0, s>>>(m, o, p, B);
  else
    xmd_variant_kernel<1, kStage, kSchedule, kOneCopy>
        <<<grid, kThreads, 0, s>>>(m, o, p, B);
  return (int)cudaGetLastError();
}

}  // namespace

// v: kStage, kSchedule, kOneCopy as bits 0, 1, 2
extern "C" int bls_xmd_variant(const void* m, void* o, const void* p, int B,
                               int v, void* s) {
  switch (v) {
    case 0: return launch_xmd<false, false, false>(m, o, p, B, s);
    case 1: return launch_xmd<true, false, false>(m, o, p, B, s);
    case 2: return launch_xmd<false, true, false>(m, o, p, B, s);
    case 3: return launch_xmd<true, true, false>(m, o, p, B, s);
    case 4: return launch_xmd<false, false, true>(m, o, p, B, s);
    case 5: return launch_xmd<true, false, true>(m, o, p, B, s);
  }
  return (int)cudaErrorInvalidValue;
}
"""
# stage, schedule, one compression copy
XMD_VARIANTS = ((0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0), (0, 0, 1),
                (1, 0, 1))

SQR_SOURCE = """#include "fp384.cuh"
#include "mont_sqr.cuh"

// sqr_kernel<threads, per>
extern "C" int bls_sqr_variant(const void* a, void* out, int G, int B,
                               int threads, int per, void* stream) {
  if (threads == 128 && per == 1)
    return montsqr::launch_sqr_shape<128, 1>(a, out, G, B, stream);
  if (threads == 128 && per == 2)
    return montsqr::launch_sqr_shape<128, 2>(a, out, G, B, stream);
  if (threads == 256 && per == 1)
    return montsqr::launch_sqr_shape<256, 1>(a, out, G, B, stream);
  if (threads == 256 && per == 2)
    return montsqr::launch_sqr_shape<256, 2>(a, out, G, B, stream);
  return (int)cudaErrorInvalidValue;
}
"""

SQR_SHAPES = ((128, 1), (128, 2), (256, 1), (256, 2))


def ptxas(log: str, name: str) -> dict:
    """Registers and spill bytes of every kernel whose mangled name holds
    `name`, by mangled name."""
    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"'(\w+)'", line)
            cur = m[1] if m and name in m[1] else None
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            out.setdefault(cur, {})["registers"] = int(m[1])
        elif cur and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out.setdefault(cur, {})["spill_bytes"] = int(m[1]) + int(m[2])
    return out


def sass_counts(lib: Path, fun: str) -> dict:
    """Instructions of the first kernel in `lib` whose mangled name holds
    `fun`, from `cuobjdump -sass`: in all and by opcode (the part before
    the first dot)."""
    from bls12_381_torch.kernels import build as kbuild

    tool = Path(kbuild.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    ops, mine = {}, False
    for line in text.splitlines():
        if "Function :" in line:
            if ops:
                break
            mine = fun in line
        elif mine and (m := re.search(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                line)):
            ops[m[1]] = ops.get(m[1], 0) + 1
    top = dict(sorted(ops.items(), key=lambda kv: -kv[1])[:16])
    return {"function": fun, "instructions": sum(ops.values()), "top": top}


def start_build(src: Path, lib: Path, include: Path, flags, nvcc: str):
    cmd = [nvcc, *flags, "-I", str(include), "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def parent_xmd_params(sha256, dst: bytes, len_in_bytes: int,
                      msg_len: int) -> bytes:
    """The parent tree's XmdParams ("<8I4I256s"), from the same host
    values."""
    dst = sha256.reduce_dst(dst)
    return struct.pack("<8I4I256s", *sha256.zpad_midstate(), msg_len,
                       len_in_bytes, sha256.xmd_ell(len_in_bytes),
                       len(dst) + 1, dst + bytes([len(dst)]))


def main() -> None:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the parent commit to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("xmd_sqr_variants: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from bls12_381_torch.kernels import build as kbuild
    from bls12_381_torch.kernels import mont, sha256

    root = kbuild.BUILD_DIR / "variants" / "xmd_sqr"
    root.mkdir(parents=True, exist_ok=True)
    csrc = kbuild.CSRC
    flags, nvcc = kbuild.NVCC_FLAGS, kbuild.nvcc_path()
    jobs = {}
    for name, text in (("xmd", XMD_SOURCE), ("sqr", SQR_SOURCE)):
        (root / f"{name}.cu").write_text(text)
        lib = root / f"lib{name}.so"
        jobs[name] = (start_build(root / f"{name}.cu", lib, csrc, flags,
                                  nvcc), lib)
    if args.parent is not None:
        pcsrc = args.parent / "bls12_381_torch" / "kernels" / "csrc"
        for stem in ("sha256", "mont"):
            lib = root / f"libparent_{stem}.so"
            jobs[f"parent_{stem}"] = (start_build(
                pcsrc / f"{stem}.cu", lib, pcsrc, flags, nvcc), lib)
    libs, logs = {}, {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"xmd_sqr_variants: {name} failed to build:\n{log}")
        libs[name], logs[name] = ctypes.CDLL(str(lib)), log
    P, I = ctypes.c_void_p, ctypes.c_int
    libs["xmd"].bls_xmd_variant.argtypes = (P, P, P, I, I, P)
    libs["sqr"].bls_sqr_variant.argtypes = (P, P, I, I, I, I, P)
    if "parent_sha256" in libs:
        libs["parent_sha256"].bls_expand_xmd_sha256.argtypes = (P, P, P, I,
                                                                P)
        libs["parent_mont"].bls_sqr.argtypes = (P, P, I, I, P)
    usage = {"xmd": ptxas(logs["xmd"], "xmd_variant_kernel"),
             "sqr": ptxas(logs["sqr"], "sqr_kernel")}
    for name in ("parent_sha256", "parent_mont"):
        if name in logs:
            usage[name] = ptxas(logs[name], "xmd_sha256_kernel"
                                if name == "parent_sha256" else "sqr_kernel")
    print(json.dumps({"ptxas": usage}), flush=True)
    sass = {"library xmd (load 16)": (kbuild.lib_path("sha256"),
                                      "17xmd_sha256_kernelILi16E"),
            "library sqr": (kbuild.lib_path("mont"), "10sqr_kernel")}
    if "parent_sha256" in libs:
        sass["parent xmd"] = (jobs["parent_sha256"][1], "xmd_sha256_kernel")
    kbuild.build_all(("sha256", "mont"))
    for name, (lib, fun) in sass.items():
        print(json.dumps({"sass": name, **sass_counts(lib, fun)}),
              flush=True)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(rc, name):
        if rc != 0:
            sys.exit(f"xmd_sqr_variants: {name} launch returned {rc}")

    # --- XMD
    def xmd_call(stage, schedule, one):
        def call(x):
            out = torch.empty((x.shape[0], OUT_LEN), dtype=torch.uint8,
                              device=x.device)
            params = sha256.xmd_params(
                DST, OUT_LEN, MSG_LEN, sha256.io_width(x.data_ptr(), MSG_LEN),
                sha256.io_width(out.data_ptr(), OUT_LEN))
            check(libs["xmd"].bls_xmd_variant(
                x.data_ptr(), out.data_ptr(), params, x.shape[0],
                stage + 2 * schedule + 4 * one, stream()),
                f"xmd stage={stage} schedule={schedule} one={one}")
            return out
        return call

    def parent_xmd(x):
        out = torch.empty((x.shape[0], OUT_LEN), dtype=torch.uint8,
                          device=x.device)
        check(libs["parent_sha256"].bls_expand_xmd_sha256(
            x.data_ptr(), out.data_ptr(),
            parent_xmd_params(sha256, DST, OUT_LEN, MSG_LEN), x.shape[0],
            stream()), "parent xmd")
        return out

    xmd_calls = {"library": lambda x: sha256.expand_message_xmd_sha256(
        x, DST, OUT_LEN)}
    for stage, schedule, one in XMD_VARIANTS:
        xmd_calls[f"stage={stage} schedule={schedule} one_copy={one}"] = (
            xmd_call(stage, schedule, one))
    if "parent_sha256" in libs:
        xmd_calls["parent"] = parent_xmd

    # --- square
    def sqr_call(threads, per):
        def call(a):
            out = torch.empty_like(a)
            check(libs["sqr"].bls_sqr_variant(
                a.data_ptr(), out.data_ptr(), a.shape[0], a.shape[2],
                threads, per, stream()), f"sqr {threads}x{per}")
            return out
        return call

    def parent_sqr(a):
        out = torch.empty_like(a)
        check(libs["parent_mont"].bls_sqr(a.data_ptr(), out.data_ptr(),
                                          a.shape[0], a.shape[2], stream()),
              "parent sqr")
        return out

    sqr_calls = {"library": mont.sqr}
    for threads, per in SQR_SHAPES:
        sqr_calls[f"threads={threads} lanes={per}"] = sqr_call(threads, per)
    if "parent_mont" in libs:
        sqr_calls["parent"] = parent_sqr

    def timed(calls, fns, kernel):
        """Per call: device ms per launch (the mean duration of its
        kernel's events under torch.profiler, LAUNCHES launches) in each
        of REPS rounds that take the calls in turn.  A capture that falls
        short of LAUNCHES events is taken again, up to three times."""
        ms = {name: [] for name in calls}
        for _ in range(REPS):
            for name, fn in fns.items():
                fn()
                for _ in range(3):
                    evs = chip_smoke.device_events(
                        lambda fn=fn: [fn() for _ in range(LAUNCHES)])
                    durs = [e - s for n, s, e in evs if kernel in n]
                    if len(durs) == LAUNCHES:
                        break
                else:
                    sys.exit(f"xmd_sqr_variants: {name}: {len(durs)} "
                             f"{kernel} events for {LAUNCHES} launches")
                ms[name].append(statistics.mean(durs) / 1e3)
        return ms

    ok = True
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    msgs = torch.randint(0, 256, (XMD_WIDTHS[-1], MSG_LEN), generator=gen,
                         device="cuda", dtype=torch.uint8)
    for B in XMD_WIDTHS:
        x = msgs[:B]
        want = xmd_calls["library"](x)
        equal = {n: bool(torch.equal(c(x), want))
                 for n, c in xmd_calls.items()}
        ok &= all(equal.values())
        ms = timed(xmd_calls, {n: (lambda c=c: c(x))
                               for n, c in xmd_calls.items()},
                   "xmd_")
        for name in xmd_calls:
            print(json.dumps({"kernel": "xmd_sha256", "variant": name,
                              "B": B, "ms": statistics.median(ms[name]),
                              "ms_reps": ms[name], "equal": equal[name]}),
                  flush=True)
    for B in SQR_WIDTHS:
        a = chip_smoke.rand_fp((1, B), gen, "cuda").transpose(0, 1) \
            .contiguous()
        want = mont.sqr(a)
        equal = {n: bool(torch.equal(c(a), want))
                 for n, c in sqr_calls.items()}
        ok &= all(equal.values())
        fns = {}
        for name, c in sqr_calls.items():
            fns[name], copies = chip_smoke.rotating(c, a)
        ms = timed(sqr_calls, fns, "sqr_kernel")
        bound_ms, by = chip_smoke.bound(4 * B * 24 * 2,
                                        B * chip_smoke.sqr_imads())
        for name in sqr_calls:
            print(json.dumps({"kernel": "sqr", "variant": name, "G": 1,
                              "B": B, "ms": statistics.median(ms[name]),
                              "ms_reps": ms[name], "equal": equal[name],
                              "operand_copies": copies,
                              "bound_ms": bound_ms, "bound_by": by}),
                  flush=True)
        del fns, a, want
    if not ok:
        sys.exit("xmd_sqr_variants: a variant disagrees with the library")


if __name__ == "__main__":
    main()
