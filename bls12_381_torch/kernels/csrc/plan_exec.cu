// Expression-plan interpreter: one static Fp DAG (a whole tower operation)
// per launch (wrapper, table format and notes: kernels/plan_exec.py).
//
// The host compiles each plan once into an int32 instruction table, ordered
// by the plan's level groups.  One thread per batch lane walks the table in
// the same order as every other thread (no divergence); each node's value is
// 12 32-bit words in a per-lane slot of `scratch`, laid out [slot, 12, B] so
// a warp's accesses to one word are 32 neighbouring addresses.  Slots
// 0..n_in-1 hold the inputs.
//
// Instruction (kInstrWidth int32): [op, dst, n_terms, src0, src1, ...]
//   op 1 add: dst = src0 + src1      op 3 neg: dst = -src0
//   op 2 sub: dst = src0 - src1      op 4 sop: dst = sum_t src[2t] src[2t+1]
// all mod p and canonical; sop takes n_terms <= 8 with one reduction.
#include "fp384.cuh"

using namespace montgomery;
using fp384::Field;

namespace {

constexpr int kBlock = 128;
constexpr int kMaxTerms = 8;
constexpr int kInstrWidth = 3 + 2 * kMaxTerms;
enum { kAdd = 1, kSub = 2, kNeg = 3, kSop = 4 };

__global__ void __launch_bounds__(kBlock)
plan_kernel(const int32_t* __restrict__ ops, int32_t* __restrict__ out,
            uint32_t* scratch, const int32_t* __restrict__ instr,
            int n_instr, const int32_t* __restrict__ out_slots, int n_in,
            int n_out, int B) {
  constexpr int W = Field::W;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t slot = (size_t)W * B;
  uint32_t* s = scratch + lane;

#pragma unroll 1
  for (int k = 0; k < n_in; ++k) {
    uint32_t x[W];
    load16(ops + (size_t)k * Field::L16 * B + lane, B, x);
    store32(s + k * slot, B, x);
  }

#pragma unroll 1
  for (int n = 0; n < n_instr; ++n) {
    const int32_t* ins = instr + (size_t)n * kInstrWidth;
    const int op = __ldg(ins);
    uint32_t r[W];
    if (op == kSop) {
      const int T = __ldg(ins + 2);
      uint32_t acc[2 * W + 1];
      zero_wide(acc);
#pragma unroll 1
      for (int t = 0; t < T; ++t) {
        uint32_t x[W], y[W];
        load32(s + __ldg(ins + 3 + 2 * t) * slot, B, x);
        load32(s + __ldg(ins + 4 + 2 * t) * slot, B, y);
        mul_acc(acc, x, y);
      }
      mont_reduce<Field>(acc, r);
    } else {
      uint32_t x[W], y[W];
      load32(s + __ldg(ins + 3) * slot, B, x);
      if (op == kNeg) {
#pragma unroll
        for (int k = 0; k < W; ++k) y[k] = 0;
        mod_sub<Field>(y, x, r);
      } else {
        load32(s + __ldg(ins + 4) * slot, B, y);
        if (op == kAdd) {
          mod_add<Field>(x, y, r);
        } else {
          mod_sub<Field>(x, y, r);
        }
      }
    }
    store32(s + __ldg(ins + 1) * slot, B, r);
  }

#pragma unroll 1
  for (int o = 0; o < n_out; ++o) {
    uint32_t x[W];
    load32(s + __ldg(out_slots + o) * slot, B, x);
    store16(out + (size_t)o * Field::L16 * B + lane, B, x);
  }
}

}  // namespace

extern "C" int bls_plan_exec(const void* ops, void* out, void* scratch,
                             const void* instr, int n_instr,
                             const void* out_slots, int n_in, int n_out,
                             int B, int instr_width, void* stream) {
  if (instr_width != kInstrWidth || B < 1 || n_in < 0 || n_out < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int grid = (B + kBlock - 1) / kBlock;
  plan_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ops, (int32_t*)out, (uint32_t*)scratch,
      (const int32_t*)instr, n_instr, (const int32_t*)out_slots, n_in, n_out,
      B);
  return (int)cudaGetLastError();
}
