// Fixed-exponent power in Fp2 = Fp[u]/(u^2 + 1) on Hopper (wrapper and
// plain version: kernels/mont.py `fp2_pow_fixed`, `fp2_pow_plain`).
//
// Replaces the JAX package's `tower.fp2_pow` (bls12_381_tpu/fields/
// tower.py:287: a lax.scan over the exponent's bits of an fp2_sqr, an
// fp2_mul and a select, whose Fp products are sop_pallas launches) with one
// launch, on the Fp power's 4-bit digit schedule (mont_pow.cuh
// `mont_pow_kernel`): the digits by value in the parameter block, a 16-entry
// window table per lane in shared memory, the leading zero digits and the
// products by entry 0 skipped.  Every value is canonical at the store, so
// the result is the JAX schedule's.
//
// Bound.  A lane's chain of dependent Fp2 steps: after the leading digit,
// 4 squares per digit and a product per nonzero digit (at (p-1)/2: 376
// squares, 90 products and the table's 14).  At the paths' widths (B <=
// 1024: at most 64 warps on 132 SMs) nothing overlaps one lane's chain with
// another's, and the multiplies alone are some 40 times shorter than it
// (chip_smoke.py `fp2_pow_work`).  The design shortens the chain:
//
// 1. Two threads per lane, one per coordinate, neighbours in a warp
//    (thread t holds `mine` = coordinate t of the accumulator and `other`
//    = coordinate 1 - t).  A square is one Montgomery product per thread,
//    c0 = (a0 + a1)(a0 - a1) and c1 = 2 a0 a1; a product by the table's
//    (b0, b1) one two-term sum per thread, c0 = a0 b0 + (2p - a1) b1 and
//    c1 = a1 b0 + a0 b1.  After each step the other coordinate comes over
//    in 12 independent __shfl_xor_sync; both threads read both coordinates
//    of a table entry (a broadcast read).  The chain per lane falls from
//    ~1,064 products to ~530.
// 2. A shorter Montgomery product (`mont_sum`): CIOS over 32-bit words
//    whose additions ride the hardware carry flag (PTX mad.lo.cc /
//    madc.hi.cc / addc), the approach of Supranational's sppark `mont_t`,
//    written anew.  The even and the odd words of each row go to two
//    accumulators, two carry chains side by side, and the reduction's row
//    follows in the same two.  The flag does not survive from one asm
//    statement to the next, so each chain is one statement; the statements
//    are not volatile, so ptxas may schedule around them.
// 3. Lazy reduction.  4p < 8p < R = 2^384, so a product of a value below
//    4p and one below 2p, or a sum of two products of values below 2p, is
//    < 8p^2 < pR, and its Montgomery reduction is < 8p^2/R + p < 2p with no
//    conditional subtraction.  The accumulator stays below 2p; the square's
//    a0 - a1 is brought into [0, 2p) (16p > R: both factors below 4p would
//    not do); the result is made canonical once, before the store.  Each
//    bound is stated beside the code; tests/test_torch_fp2_pow_model.py
//    models every step on Python integers and asserts them.
// 4. Launch shape: kLanes lanes per block (2 kLanes threads), 1.5 KB of
//    table per lane (16 x 2 x 12 words, word-major, lane innermost: a
//    warp's 16 lanes read 16 consecutive words), the shared-memory cap
//    raised once per device, not on every launch.  kLanes = 64: at 1024
//    lanes 32 and 64 tie and 128 is 1.55 times slower (two warps on a
//    scheduler), within 1 % of each other at 2^16 lanes
//    (scripts/fp2_pow_variants.py, H100 80GB HBM3 at 700 W; PERF.md).
// 5. The ragged tail: a pair past B runs lane B - 1's chain and skips its
//    store, so every thread of a warp reaches every shuffle and the full
//    mask is right (2 kLanes is a multiple of 32).
#pragma once

#include <atomic>

#include "carry_chain.cuh"
#include "fp384.cuh"

namespace fp2pow {

using montgomery::kPowDigits;
using montgomery::PowDigits;
using montgomery::PowIO;
using carry::add_words;
using carry::kN0;
using carry::mad_row;
using carry::madc_row;
using carry::p_word;
using carry::sub_words;
using carry::two_p_word;
using carry::W;

constexpr int kLanes = 64;  // lanes per block (mont.py FP2_POW_LANES)

// r = (x1 y1 [+ x2 y2]) R^-1 mod p, in [0, 2p), for a sum < pR (here
// < 8p^2: x1 < 4p, y1 < 2p alone, or x1, y1, y2 < 2p, x2 <= 2p with the
// second term), so the result is < sum/R + p < 2p.  r may alias x1 or x2:
// it is written after the last read.
//
// CIOS with 32-bit digits.  The running value is A + B: A holds row i's
// word products x_i y_j for even j (words 0..12), B those for odd j
// (words 0..13, word 0 left from the row before), and the reduction's
// m p_j the same way, m = (A[0] + B[0]) N0 mod 2^32, so A[0] + B[0] = 0 mod
// 2^32 after the row.  Both words are then dropped (the shift by one word)
// and their sum, 0 or 2^32, carries 1 into the next row's A[0] exactly
// where B[0] != 0.  Bounds (each row adds < (K + 1) 2^384 to A and
// < K 2^416 + 2^413 to B, then divides both by 2^32; K terms): A < 2^386
// and B < 2^418 throughout, so neither top word carries out; after the
// last row A + B + carry is the result, < 2p < 2^384.
template <bool kTwo>
__device__ __forceinline__ void mont_sum(const uint32_t (&x1)[W],
                                         const uint32_t (&y1)[W],
                                         const uint32_t (&x2)[W],
                                         const uint32_t (&y2)[W],
                                         uint32_t (&r)[W]) {
  uint32_t p[W];
#pragma unroll
  for (int j = 0; j < W; ++j) p[j] = p_word(j);
  uint32_t A[W + 1], B[W + 2];
  // row 0 of the first term lands in empty words: plain multiplies
#pragma unroll
  for (int j = 0; j < W; j += 2) {
    A[j] = x1[0] * y1[j];
    A[j + 1] = __umulhi(x1[0], y1[j]);
    B[j + 1] = x1[0] * y1[j + 1];
    B[j + 2] = __umulhi(x1[0], y1[j + 1]);
  }
  A[W] = 0, B[0] = 0, B[W + 1] = 0;
  uint32_t cin = 0;  // the dropped words' carry: 1 where cin != 0
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if (i > 0) {
      madc_row(A, x1[i], y1, cin);
      mad_row(B + 1, x1[i], y1 + 1);
    }
    if (kTwo) {
      mad_row(A, x2[i], y2);
      mad_row(B + 1, x2[i], y2 + 1);
    }
    const uint32_t m = (A[0] + B[0]) * kN0;
    mad_row(A, m, p);
    mad_row(B + 1, m, p + 1);
    cin = B[0];
#pragma unroll
    for (int j = 0; j < W; ++j) A[j] = A[j + 1];
#pragma unroll
    for (int j = 0; j <= W; ++j) B[j] = B[j + 1];
    A[W] = 0, B[W + 1] = 0;
  }
  uint32_t s[W], b[W];
#pragma unroll
  for (int j = 0; j < W; ++j) s[j] = A[j], b[j] = B[j];
  add_words(s, b, cin);
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = s[j];
}

// other = the neighbour's mine (the other coordinate of the lane).
__device__ __forceinline__ void exchange(const uint32_t (&mine)[W],
                                         uint32_t (&other)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j)
    other[j] = __shfl_xor_sync(0xffffffffu, mine[j], 1);
}

// (a0 + a1 u)^2 on a pair, mine and other < 2p in and out: thread 0
// c0 = (a0 + a1)(a0 - a1), thread 1 c1 = (a0 + a0) a1.
__device__ __forceinline__ void sqr_step(bool t1, uint32_t (&mine)[W],
                                         uint32_t (&other)[W]) {
  uint32_t x[W], d[W], tp[W];
#pragma unroll
  for (int j = 0; j < W; ++j) x[j] = t1 ? other[j] : mine[j], d[j] = mine[j];
  add_words(x, other);  // a0 + a1 or 2 a0: < 4p < 2^383, no carry out
  const uint32_t borrow = sub_words(d, other);  // a0 - a1 on thread 0
#pragma unroll
  for (int j = 0; j < W; ++j) tp[j] = two_p_word(j) & borrow;
  add_words(d, tp);  // + 2p where negative: in [0, 2p)
#pragma unroll
  for (int j = 0; j < W; ++j) d[j] = t1 ? mine[j] : d[j];  // a1 on thread 1
  mont_sum<false>(x, d, x, d, mine);  // < 4p x 2p: in [0, 2p)
  exchange(mine, other);
}

// (a0 + a1 u)(b0 + b1 u) on a pair, mine, other, b0, b1 < 2p in, mine and
// other < 2p out: thread 0 c0 = a0 b0 + (2p - a1) b1, thread 1
// c1 = a1 b0 + a0 b1 (mine b0 + v b1 on both).
__device__ __forceinline__ void mul_step(bool t1, uint32_t (&mine)[W],
                                         uint32_t (&other)[W],
                                         const uint32_t (&b0)[W],
                                         const uint32_t (&b1)[W]) {
  uint32_t v[W];
#pragma unroll
  for (int j = 0; j < W; ++j) v[j] = two_p_word(j);
  sub_words(v, other);  // 2p - a1 in (0, 2p]: no borrow
#pragma unroll
  for (int j = 0; j < W; ++j) v[j] = t1 ? other[j] : v[j];
  mont_sum<true>(mine, b0, v, b1, mine);  // < 2 (2p)^2: in [0, 2p)
  exchange(mine, other);
}

__global__ void __launch_bounds__(2 * kLanes)
fp2_pow_kernel(const PowIO io, int n_digits, int B,
               const __grid_constant__ PowDigits e) {
  constexpr int coord = W * kLanes;   // words from one coordinate to the next
  constexpr int entry = 2 * coord;    // words from one table entry to the next
  extern __shared__ uint32_t table[];  // [16][2][W][kLanes]
  const int x = threadIdx.x >> 1;     // the pair's lane in the block
  const bool t1 = threadIdx.x & 1;    // the coordinate this thread holds
  const int lane = blockIdx.x * kLanes + x;
  const bool live = lane < B;
  const int src = live ? lane : B - 1;  // a pair past B runs lane B - 1
  uint32_t* col = table + x;
  uint32_t* mine_col = col + (t1 ? coord : 0);
  uint32_t a0[W], a1[W], mine[W], other[W];
  montgomery::load16(io.a[0] + src, B, a0);  // canonical: < p
  montgomery::load16(io.a[1] + src, B, a1);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    mine[j] = t1 ? 0u : fp384::Field::one(j);  // entry 0: one
    other[j] = t1 ? a0[j] : a1[j];
  }
  montgomery::store32(mine_col, kLanes, mine);
#pragma unroll
  for (int j = 0; j < W; ++j) mine[j] = t1 ? a1[j] : a0[j];
  montgomery::store32(mine_col + entry, kLanes, mine);  // entry 1: a
#pragma unroll 1
  for (int k = 2; k < 16; ++k) {  // entry k = a^k, < 2p
    mul_step(t1, mine, other, a0, a1);
    montgomery::store32(mine_col + k * entry, kLanes, mine);
  }
  __syncwarp();  // the neighbour's column is read below
  int i = 0;
  while (i < n_digits && e.d[i] == 0) ++i;
  const int first = i < n_digits ? e.d[i] : 0;
  montgomery::load32(col + first * entry + (t1 ? coord : 0), kLanes, mine);
  montgomery::load32(col + first * entry + (t1 ? 0 : coord), kLanes, other);
#pragma unroll 1
  for (++i; i < n_digits; ++i) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) sqr_step(t1, mine, other);
    const int d = e.d[i];  // the same on every thread: no divergence
    if (d != 0) {
      uint32_t b0[W], b1[W];
      montgomery::load32(col + d * entry, kLanes, b0);
      montgomery::load32(col + d * entry + coord, kLanes, b1);
      mul_step(t1, mine, other, b0, b1);
    }
  }
  uint32_t c[W];
#pragma unroll
  for (int j = 0; j < W; ++j) c[j] = mine[j];
  uint32_t p[W];
#pragma unroll
  for (int j = 0; j < W; ++j) p[j] = p_word(j);
  const uint32_t below = sub_words(c, p);  // canonical: mine < 2p
#pragma unroll
  for (int j = 0; j < W; ++j) c[j] = below ? mine[j] : c[j];
  if (live) montgomery::store16((t1 ? io.out[1] : io.out[0]) + lane, B, c);
}

// Launch fp2_pow_kernel on `stream`: (out0 + out1 u) = (a0 + a1 u)^e over
// int32 [24, B] limbs; digits: n_digits host bytes, each < 16, most
// significant first.  Its 96 KB of shared memory per block is above the
// 48 KB a launch gets by default: the cap is raised once per device of the
// process (an attribute of the kernel on the current device), not on every
// launch.  Returns cudaGetLastError() (or the error of raising the cap), or
// cudaErrorInvalidValue for a width, count or digit the kernel does not
// take.  static, not inline: the flag is then this library's own (an inline
// function's static is one object across every library of the process that
// holds this header, and would say another library's kernel was raised).
static int launch_fp2_pow(const void* a0, const void* a1, void* out0,
                          void* out1, const uint8_t* digits, int n_digits,
                          int B, void* stream) {
  constexpr int smem = 16 * 2 * W * (int)sizeof(uint32_t) * kLanes;
  static std::atomic<unsigned long long> raised{0};  // bit d: device d
  if (B < 1 || n_digits < 0 || n_digits > kPowDigits)
    return (int)cudaErrorInvalidValue;
  PowDigits e = {};
  for (int i = 0; i < n_digits; ++i) {
    if (digits[i] > 15) return (int)cudaErrorInvalidValue;
    e.d[i] = digits[i];
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!bit || !(raised.load() & bit)) {
    err = cudaFuncSetAttribute(fp2_pow_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    raised.fetch_or(bit);
  }
  PowIO io = {};
  io.a[0] = (const int32_t*)a0, io.a[1] = (const int32_t*)a1;
  io.out[0] = (int32_t*)out0, io.out[1] = (int32_t*)out1;
  const int grid = (B + kLanes - 1) / kLanes;
  fp2_pow_kernel<<<grid, 2 * kLanes, smem, (cudaStream_t)stream>>>(
      io, n_digits, B, e);
  return (int)cudaGetLastError();
}

}  // namespace fp2pow
