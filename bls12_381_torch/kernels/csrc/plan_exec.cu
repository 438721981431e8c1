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
//
// Fold mode (`plan_kernel<true>`, `bls_plan_fold`): the sums of the runs of
// equal `dest` along K sorted lanes (the MSM's buckets, the key sets of
// ops/aggregate.py), one group-law plan per lane added.  It replaces the
// segmented scan of complete additions (ops/msm.py), whose ~2K additions in
// 2 lg K launches came with a pass of torch glue per level; the TPU kernel
// has no counterpart (the JAX package scans).  Each lane of a block's tile
// is a *folder* that walks a run of M consecutive lanes with its
// accumulator in the plan's first n_out input slots: the plan is compiled
// with output o written into input o's slot (kernels/plan_exec.py,
// `compile_plan(..., fold=True)`), so a step is: load the lane's operand
// (the point `order` names, y negated where `negs` is set) into the other
// input slots, reset the accumulator to the identity at a segment's first
// lane, run the phases.  A piece of a segment that ends inside the run is
// written at its end: a segment's total (16-bit limbs, `totals[dest]`) where
// the piece is the whole segment, else one of the run's two partial slots
// (first: the piece open on the left; last: open on the right), 32-bit
// words, point-major, with a content flag; a slot with no piece takes the
// identity and no content.  The partials, sorted like the lanes, are the
// next level's lanes (the full-addition plan), until one run holds every
// lane; a segment is written where its pieces meet, once.  Bound: the
// plan's multiplies, one mixed addition per lane; the operand's 96 bytes
// (G1) a lane come packed, point-major, so a step reads three sectors a
// lane and no scattered limbs.
#include <atomic>

#include "fp384.cuh"

using namespace montgomery;
using fp384::Field;

// The fold mode's arguments (kernels/plan_exec.py `_FoldArgs`, field for
// field), passed by value.
struct PlanFoldArgs {
  const uint32_t* src;       // operand points, point-major: src_words each
  const int64_t* order;      // lane -> source point; null: the lane itself
  const uint8_t* negs;       // negate operand rows [neg_lo, neg_hi); or null
  const int64_t* dest;       // lane -> its segment's output (dropped outside
                             // [0, n_totals)), non-decreasing
  const uint8_t* content;    // the lane holds a piece; null: every lane
  int32_t* totals;           // [n_out rows][L16][n_totals] 16-bit limbs
  uint32_t* part;            // [2 runs][n_out rows * W] the partial pieces
  uint8_t* part_content;     // [2 runs]
  int K;                     // lanes
  int M;                     // lanes a folder walks
  int n_totals;
  int src_words;
  int neg_lo, neg_hi;
  unsigned one_mask;         // accumulator rows of the identity that are 1
};

namespace {

constexpr int kMaxThreads = 192;
constexpr int kMinBlocks = 4;  // per SM: <= 85 registers a thread
constexpr int kMaxLaneLog2 = 6;
constexpr int kMaxSmem = 232448;  // 227 KB: a block's shared-memory limit
constexpr int kStaticSmem = 48 * 1024;
enum { kAdd = 1, kSub = 2, kNeg = 3, kSop = 4 };
// a folder's step (fold mode), decided by its lane's thread
enum : unsigned {
  kLoad = 1,         // read the lane's operand
  kReset = 2,        // set the accumulator to the identity first
  kNegate = 4,       // negate the operand's rows [neg_lo, neg_hi)
  kEmitTotal = 8,    // the piece that ended is its segment: totals[dest]
  kEmitFirst = 16,   // ... the run's first partial (open on the left)
  kEmitLast = 32,    // ... the run's last partial (open on the right)
  kClearFirst = 64,  // the run has no first partial: the identity
  kClearLast = 128,  // ... no last partial
  kSeen = 256,       // the piece holds content (state and emitted flag)
  kOpenLeft = 512,   // state: the piece began before the run
  kEmit = kEmitTotal | kEmitFirst | kEmitLast,
  kAcc = kReset | kEmit | kClearFirst | kClearLast,
};

__device__ __forceinline__ int u16_at(const uint8_t* prog, int byte_off) {
  return *(const uint16_t*)(prog + byte_off);
}

// The phases of one evaluation of the plan over a block's lanes (their
// inputs in their slots): each round reads every source before it writes
// any destination.
__device__ __forceinline__ void run_phases(const uint16_t* phases,
                                           const uint16_t* rows_at,
                                           const uint32_t* rows,
                                           uint32_t* vals, int n_phases,
                                           int lt_log2, int live_lanes,
                                           int slot) {
  constexpr int W = Field::W;
  const int lt = 1 << lt_log2;
  const int lane_mask = lt - 1;
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
}

// Folder g's step s (fold mode, by the thread of its lane): returns what
// the step does (the flags above) and sets its operand's point and the
// output of the piece it ends; `state` (kOpenLeft, kSeen) and `prev_dest`
// carry over from step to step.  Writes the run's partials' content
// flags.
__device__ __forceinline__ unsigned fold_step(const PlanFoldArgs& a, int g,
                                              int s, unsigned& state,
                                              int64_t& prev_dest, int& src,
                                              int& out) {
  const int64_t base = (int64_t)g * a.M;
  const int64_t i = base + s;
  const bool cur = s < a.M && i < a.K;
  const int64_t d = cur ? a.dest[i] : 0;
  unsigned f = 0;
  if (s == 0) {
    const int64_t last = (base + a.M < a.K ? base + a.M : a.K) - 1;
    const int64_t dl = a.dest[last];
    const bool open_left = base > 0 && a.dest[base - 1] == d;
    const bool open_right = last + 1 < a.K && a.dest[last + 1] == dl;
    if (!open_left) f |= kClearFirst;
    // the last piece is open on the right and is not the first one open on
    // the left too (a run inside one segment has one partial, the first)
    if (!open_right || (open_left && dl == d)) f |= kClearLast;
    state = open_left ? kOpenLeft : 0;
    f |= kReset;
  } else if (i - 1 < a.K) {
    const int64_t dp = prev_dest;
    if (!cur || d != dp) {  // lane i - 1 ends a piece
      const bool closed_right = cur || i >= a.K || a.dest[i] != dp;
      const unsigned seen = state & kSeen;
      if (state & kOpenLeft) {
        f |= kEmitFirst | seen;
      } else if (!closed_right) {
        f |= kEmitLast | seen;
      } else if (seen && dp >= 0 && dp < a.n_totals) {
        f |= kEmitTotal;
        out = (int)dp;
      }
      state = 0;
      if (cur) f |= kReset;
    }
  }
  if (cur) {
    f |= kLoad;
    prev_dest = d;
    if (!a.content || a.content[i]) state |= kSeen;
    if (a.negs && a.negs[i]) f |= kNegate;
    src = a.order ? (int)a.order[i] : (int)i;
  }
  uint8_t* pc = a.part_content + 2 * (int64_t)g;
  if (f & (kClearFirst | kEmitFirst)) pc[0] = (f & kEmitFirst) && (f & kSeen);
  if (f & (kClearLast | kEmitLast)) pc[1] = (f & kEmitLast) && (f & kSeen);
  return f;
}

// Shared memory: the program's prog_vecs 16-byte vectors, then the slots;
// in fold mode then, from the next 8 bytes, per folder its last lane's
// dest, the step's flags, operand point and output, and its state.  Plain
// mode: B lanes, one evaluation each.  Fold mode: B folders (runs), the
// rest in `fold`.
template <bool kFold>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
plan_kernel(const int32_t* __restrict__ ops, int32_t* __restrict__ out,
            const uint4* __restrict__ program, int prog_vecs, int B,
            int lt_log2, const PlanFoldArgs fold) {
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

  if constexpr (kFold) {
    const PlanFoldArgs& a = fold;
    // the accumulator is input rows [0, n_out), and output o is written
    // into input o's slot; the operand is input rows [n_out, n_loads)
    const int acc_words = n_out * W;
    // the folders' words, after the slots rounded up to 8 bytes
    int64_t* m_prev = (int64_t*)(vals + ((u16_at(prog, 6) * slot + 1) & ~1));
    unsigned* m_flags = (unsigned*)(m_prev + lt);
    int* m_src = (int*)(m_flags + lt);
    int* m_out = m_src + lt;
    unsigned* m_state = (unsigned*)(m_out + lt);
#pragma unroll 1
    for (int s = 0; s <= a.M; ++s) {
      unsigned f = 0;
      if (threadIdx.x < live_lanes) {
        const int l = threadIdx.x;
        f = fold_step(a, b0 + l, s, m_state[l], m_prev[l], m_src[l],
                      m_out[l]);
        m_flags[l] = f;
      }
      // the accumulator's words move only on a step that ends, starts or
      // clears a piece of some lane of the block
      const int touch = __syncthreads_or(f & kAcc);
      // items (load j, word k, lane l), lane fastest
#pragma unroll 1
      for (int it = threadIdx.x + (touch ? 0 : (acc_words << lt_log2));
           it < (n_loads * W) << lt_log2; it += blockDim.x) {
        const int l = it & lane_mask;
        if (l >= live_lanes) continue;
        const unsigned fl = m_flags[l];
        const int jk = it >> lt_log2;
        const int j = jk / W, k = jk - j * W;
        uint32_t* v = vals + io[2 * j + 1] * slot + k * lt + l;
        if (j < n_out) {
          uint32_t* part = a.part + 2 * (int64_t)(b0 + l) * acc_words +
                           j * W + k;
          if (fl & kEmitTotal) {
            const uint32_t x = *v;
            int32_t* d = a.totals + ((int64_t)j * L16 + 2 * k) * a.n_totals +
                         m_out[l];
            d[0] = (int32_t)(x & 0xffffu);
            d[a.n_totals] = (int32_t)(x >> 16);
          } else if (fl & kEmit) {
            part[(fl & kEmitLast) ? acc_words : 0] = *v;
          }
          const uint32_t id = ((a.one_mask >> j) & 1) ? Field::one(k) : 0;
          if (fl & kClearFirst) part[0] = id;
          if (fl & kClearLast) part[acc_words] = id;
          if (fl & kReset) *v = id;
        } else if (fl & kLoad) {
          *v = __ldg(a.src + (int64_t)m_src[l] * a.src_words +
                     (j - n_out) * W + k);
        }
      }
      __syncthreads();
      if (s == a.M) break;
      if (a.negs) {
        // items (negated row r, lane l)
#pragma unroll 1
        for (int it = threadIdx.x; it < (a.neg_hi - a.neg_lo) << lt_log2;
             it += blockDim.x) {
          const int l = it & lane_mask;
          if (l >= live_lanes || !(m_flags[l] & kNegate)) continue;
          const int j = n_out + a.neg_lo + (it >> lt_log2);
          uint32_t* v = vals + io[2 * j + 1] * slot + l;
          uint32_t x[W], z[W], r[W];
          load32(v, lt, x);
#pragma unroll
          for (int k = 0; k < W; ++k) z[k] = 0;
          mod_sub<Field>(z, x, r);
          store32(v, lt, r);
        }
        __syncthreads();
      }
      run_phases(phases, rows_at, rows, vals, n_phases, lt_log2, live_lanes,
                 slot);
    }
  } else {
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
      vals[s * slot + k * lt + l] =
          (uint32_t)src[0] | ((uint32_t)src[B] << 16);
    }
    __syncthreads();

    run_phases(phases, rows_at, rows, vals, n_phases, lt_log2, live_lanes,
               slot);

    // outputs: item (output o, word k, lane l), lane fastest
#pragma unroll 1
    for (int it = threadIdx.x; it < (n_out * W) << lt_log2;
         it += blockDim.x) {
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
}

// plan_kernel's ceiling on dynamic shared memory, raised to kMaxSmem once
// per device and mode (bit d: device d) at its first launch above the
// static 48 KB.  cudaFuncSetAttribute is no launch: a later launch holds
// the launch and cudaGetLastError alone, all that a stream capture records.
template <bool kFold>
cudaError_t allow_smem(int smem_bytes) {
  static std::atomic<unsigned long long> raised{0};
  if (smem_bytes <= kStaticSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (raised.load() & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(plan_kernel<kFold>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e == cudaSuccess) raised.fetch_or(bit);
  return e;
}

bool bad_shape(int B, int lt_log2, int threads, int prog_bytes,
               int smem_bytes) {
  return B < 1 || lt_log2 < 0 || lt_log2 > kMaxLaneLog2 || threads < 32 ||
         threads > kMaxThreads || threads % 32 != 0 || prog_bytes < 16 ||
         prog_bytes % 16 != 0 || smem_bytes < prog_bytes ||
         smem_bytes > kMaxSmem;
}

}  // namespace

// One launch over B lanes in tiles of 2^lt_log2 lanes, `threads` threads and
// `smem_bytes` of dynamic shared memory per block (the wrapper's
// `launch_shape`: the program's prog_bytes, then the slots); returns
// cudaGetLastError() or the refusal's error.
extern "C" int bls_plan_exec(const void* ops, void* out, const void* program,
                             int prog_bytes, int B, int lt_log2, int threads,
                             int smem_bytes, void* stream) {
  if (bad_shape(B, lt_log2, threads, prog_bytes, smem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = allow_smem<false>(smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (B + (1 << lt_log2) - 1) >> lt_log2;
  plan_kernel<false><<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const int32_t*)ops, (int32_t*)out, (const uint4*)program,
      prog_bytes / 16, B, lt_log2, PlanFoldArgs{});
  return (int)cudaGetLastError();
}

// One fold level over `runs` folders of args->M lanes, in tiles of
// 2^lt_log2 folders (the wrapper's `fold_shape`: the program, the slots,
// 24 bytes a folder); returns cudaGetLastError() or the refusal's error.
extern "C" int bls_plan_fold(const void* program, int prog_bytes,
                             const PlanFoldArgs* args, int runs, int lt_log2,
                             int threads, int smem_bytes, void* stream) {
  if (bad_shape(runs, lt_log2, threads, prog_bytes, smem_bytes) ||
      args->M < 1 || args->K < 1 ||
      (int64_t)runs * args->M < args->K ||
      (int64_t)(runs - 1) * args->M >= args->K ||
      (args->neg_hi > args->neg_lo && !args->negs)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = allow_smem<true>(smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (runs + (1 << lt_log2) - 1) >> lt_log2;
  plan_kernel<true><<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      nullptr, nullptr, (const uint4*)program, prog_bytes / 16, runs,
      lt_log2, *args);
  return (int)cudaGetLastError();
}
