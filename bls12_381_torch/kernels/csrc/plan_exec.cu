// Expression-plan interpreter: one static Fp DAG (a whole tower or group-law
// operation) per launch.  Replaces the TPU kernel `plan_exec_pallas`
// (bls12_381_tpu/kernels/plan_exec.py:778, body `_plan_kernel`), which keeps
// every node's value in VMEM and evaluates each level group as one vector
// operation over its nodes.  Wrapper, table compiler and plain version:
// kernels/plan_exec.py.
//
// Bound on this card: the multiplies.  Per lane a plan reads its K inputs and
// writes its O outputs once (96 bytes each as 16-bit limbs in int32) and does
// ~2 ((T + 1) 144 + 12) 32-bit multiplies per T-term product node; at 132
// SMs x 64 IMAD/clock that is several times the bytes' time.  What keeps a
// plan from that bound is its depth: the nodes of one DAG depth (a *phase*)
// are independent, the phases are not.
//
// Design.  A block of 192 threads owns a tile of Lt lanes (a power of two
// <= 64, picked by the wrapper: the widest tile that still gives half the
// SMs a block and keeps the block within 64 KB of shared memory, so three
// fit an SM) and keeps every live value of its lanes in shared memory,
// never in device memory:
//   vals[slot][word][lane], 12 32-bit words per (slot, lane); word stride Lt,
//   slot stride slot_words(Lt) = 13 Lt below Lt = 32 (an odd multiple of Lt:
//   the 32 / Lt nodes of a warp hit distinct banks when their slots differ
//   mod 32 / Lt), 12 Lt from Lt = 32 (a warp is 32 lanes of one node).
// The host reuses slots by liveness, so a block needs only the plan's peak
// live count of slots (<= 70 here).  The block loads its inputs once
// (16-bit limbs -> words), then walks the phases: its threads take the
// phase's (node, lane) items node-major, so a warp's threads share a node's
// op, one item per thread per round (a round of blockDim items; the widest
// phase of a pairing plan at Lt = 8 is one or two rounds); each thread reads
// its operands from shared memory into registers, runs the shared
// Montgomery product and reduction (sop) or a 12-word modular ripple
// (add / sub / neg), meets the block at a barrier, stores its result and
// meets it again.  So a round reads every source before it writes any
// destination.  Last, the outputs go to device memory as 16-bit limbs.
// Registers are held to 85 a thread (__launch_bounds__(192, 4)), so that at
// the MSM's widths three to four blocks are resident per SM with no spills;
// on a narrow batch the launch is latency-bound: a phase costs its slowest
// item's multiply-add chain, and the pairing's plans are 4-34 phases deep.
//
// The program (kernels/plan_exec.py, `_encode_program`; <= 3 KB per plan,
// padded to 16 bytes) is staged into shared memory once per block with
// 16-byte loads, ahead of the slots: a phase then reads its bounds, row
// offsets and rows at shared-memory latency instead of a chain of three
// dependent device-memory loads.
//   header   u16[8]  n_phases, n_loads, n_out, n_slots, byte offsets of:
//   phases   u16[n_phases + 1]  first row of each phase, then n_rows
//   rows_at  u16[n_rows]        word offset of each row in `rows`
//   io       u8[2 n_loads + n_out]  (operand row, slot) per load; out slots
//   rows     per row [op | T << 4, dst, src...] bytes, padded to 4:
//     op 1 add: dst = src0 + src1      op 3 neg: dst = -src0
//     op 2 sub: dst = src0 - src1      op 4 sop: dst = sum_t src[2t] src[2t+1]
//   all mod p and canonical; sop takes T <= 8 with one reduction.
#include <atomic>

#include "fp384.cuh"

using namespace montgomery;
using fp384::Field;

namespace {

constexpr int kMaxThreads = 192;
constexpr int kMinBlocks = 4;  // per SM: <= 85 registers a thread
constexpr int kMaxLaneLog2 = 6;
constexpr int kMaxSmem = 232448;  // 227 KB: a block's shared-memory limit
constexpr int kStaticSmem = 48 * 1024;
enum { kAdd = 1, kSub = 2, kNeg = 3, kSop = 4 };

__device__ __forceinline__ int u16_at(const uint8_t* prog, int byte_off) {
  return *(const uint16_t*)(prog + byte_off);
}

// Shared memory: the program's prog_vecs 16-byte vectors, then the slots.
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
plan_kernel(const int32_t* __restrict__ ops, int32_t* __restrict__ out,
            const uint4* __restrict__ program, int prog_vecs, int B,
            int lt_log2) {
  constexpr int W = Field::W;
  constexpr int L16 = Field::L16;
  extern __shared__ uint4 smem[];
  for (int i = threadIdx.x; i < prog_vecs; i += blockDim.x) {
    smem[i] = __ldg(program + i);
  }
  __syncthreads();
  const uint8_t* prog = (const uint8_t*)smem;
  uint32_t* vals = (uint32_t*)(smem + prog_vecs);

  const int n_phases = u16_at(prog, 0);
  const int n_loads = u16_at(prog, 2);
  const int n_out = u16_at(prog, 4);
  const uint16_t* phases = (const uint16_t*)(prog + u16_at(prog, 8));
  const uint16_t* rows_at = (const uint16_t*)(prog + u16_at(prog, 10));
  const uint8_t* io = prog + u16_at(prog, 12);
  const uint32_t* rows = (const uint32_t*)(prog + u16_at(prog, 14));

  const int lt = 1 << lt_log2;
  const int lane_mask = lt - 1;
  const int slot = lt * (W + (lt < 32 ? 1 : 0));  // slot stride in words
  const int b0 = blockIdx.x << lt_log2;
  const int live_lanes = min(lt, B - b0);  // the last tile may be ragged

  // inputs: item (load j, word k, lane l), lane fastest
#pragma unroll 1
  for (int it = threadIdx.x; it < (n_loads * W) << lt_log2;
       it += blockDim.x) {
    const int l = it & lane_mask;
    if (l >= live_lanes) continue;
    const int jk = it >> lt_log2;
    const int j = jk / W, k = jk - j * W;
    const int row = io[2 * j], s = io[2 * j + 1];
    const int32_t* src = ops + ((size_t)row * L16 + 2 * k) * B + b0 + l;
    vals[s * slot + k * lt + l] = (uint32_t)src[0] | ((uint32_t)src[B] << 16);
  }
  __syncthreads();

#pragma unroll 1
  for (int ph = 0; ph < n_phases; ++ph) {
    const int r0 = phases[ph];
    const int n_items = (phases[ph + 1] - r0) << lt_log2;
    // one round per blockDim items (one round for every plan the wrapper
    // sizes); the trip count is uniform, so every thread meets the barriers
#pragma unroll 1
    for (int base = 0; base < n_items; base += blockDim.x) {
      const int it = base + threadIdx.x;
      const int l = it & lane_mask;
      const bool live = it < n_items && l < live_lanes;
      uint32_t r[W];
      int dst = 0;
      if (live) {
        const uint32_t* row = rows + rows_at[r0 + (it >> lt_log2)];
        const uint32_t w0 = row[0];
        const int op = w0 & 15;
        const uint32_t* v = vals + l;
        dst = (w0 >> 8) & 255;
        if (op == kSop) {
          const int T = (w0 >> 4) & 15;
          uint32_t acc[2 * W + 1];
          zero_wide(acc);
#pragma unroll 1
          for (int t = 0; t < T; ++t) {
            // term t's slots are bytes 2 + 2t and 3 + 2t of the row
            const uint32_t w = row[(t + 1) >> 1] >> ((t & 1) ? 0 : 16);
            uint32_t x[W], y[W];
            load32(v + (w & 255) * slot, lt, x);
            load32(v + ((w >> 8) & 255) * slot, lt, y);
            mul_acc(acc, x, y);
          }
          mont_reduce<Field>(acc, r);
        } else {
          uint32_t x[W], y[W];
          load32(v + ((w0 >> 16) & 255) * slot, lt, x);
          if (op == kNeg) {
#pragma unroll
            for (int k = 0; k < W; ++k) y[k] = 0;
            mod_sub<Field>(y, x, r);
          } else {
            load32(v + (w0 >> 24) * slot, lt, y);
            if (op == kAdd) {
              mod_add<Field>(x, y, r);
            } else {
              mod_sub<Field>(x, y, r);
            }
          }
        }
      }
      __syncthreads();  // every source of the round is read ...
      if (live) store32(vals + dst * slot + l, lt, r);
      __syncthreads();  // ... before, and every result written after
    }
  }

  // outputs: item (output o, word k, lane l), lane fastest
#pragma unroll 1
  for (int it = threadIdx.x; it < (n_out * W) << lt_log2; it += blockDim.x) {
    const int l = it & lane_mask;
    if (l >= live_lanes) continue;
    const int ok = it >> lt_log2;
    const int o = ok / W, k = ok - o * W;
    const uint32_t x = vals[io[2 * n_loads + o] * slot + k * lt + l];
    int32_t* d = out + ((size_t)o * L16 + 2 * k) * B + b0 + l;
    d[0] = (int32_t)(x & 0xffffu);
    d[B] = (int32_t)(x >> 16);
  }
}

// plan_kernel's ceiling on dynamic shared memory, raised to kMaxSmem once
// per device (bit d: device d) at its first launch above the static 48 KB.
// cudaFuncSetAttribute is no launch: a later launch holds the launch and
// cudaGetLastError alone, all that a stream capture records.
std::atomic<unsigned long long> g_smem_raised{0};

cudaError_t allow_smem(int smem_bytes) {
  if (smem_bytes <= kStaticSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (g_smem_raised.load() & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(plan_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e == cudaSuccess) g_smem_raised.fetch_or(bit);
  return e;
}

}  // namespace

// One launch over B lanes in tiles of 2^lt_log2 lanes, `threads` threads and
// `smem_bytes` of dynamic shared memory per block (the wrapper's
// `launch_shape`: the program's prog_bytes, then the slots); returns
// cudaGetLastError() or the refusal's error.
extern "C" int bls_plan_exec(const void* ops, void* out, const void* program,
                             int prog_bytes, int B, int lt_log2, int threads,
                             int smem_bytes, void* stream) {
  if (B < 1 || lt_log2 < 0 || lt_log2 > kMaxLaneLog2 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || prog_bytes < 16 ||
      prog_bytes % 16 != 0 || smem_bytes < prog_bytes ||
      smem_bytes > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = allow_smem(smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (B + (1 << lt_log2) - 1) >> lt_log2;
  plan_kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const int32_t*)ops, (int32_t*)out, (const uint4*)program,
      prog_bytes / 16, B, lt_log2);
  return (int)cudaGetLastError();
}
