// Word-level Montgomery arithmetic on Hopper, shared by the field headers
// (fp384.cuh: the BLS12-381 base field, 12 words; fr256.cuh: its scalar
// field, 8 words).
//
// An element lives in registers as W little-endian 32-bit words, in
// Montgomery form with R = 2^(32 W) -- the same R as the 16-bit limbs at the
// boundary, so repacking cannot change a canonical value.  A field F is a
// struct with
//   static constexpr int W;            32-bit words per element
//   static constexpr int L16;          16-bit limbs per element (2 W)
//   static constexpr int MAX_TERMS;    terms of a fused sum, T p < R
//   static constexpr uint32_t N0;      -p^-1 mod 2^32
//   __device__ static uint32_t p(int j);    word j of the modulus
//   __device__ static uint32_t one(int j);  word j of R mod p
// Every function returns a canonical result (< p) from canonical inputs.
// The sum-of-products and fixed-exponent power kernels at the end are
// instantiated once per field.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace montgomery {

typedef unsigned long long u64;

// x[k] = limb[2k] | limb[2k+1] << 16, reading 16-bit limbs stored in int32
// with `stride` elements between consecutive limbs (the batch size).
template <int W>
__device__ __forceinline__ void load16(const int32_t* __restrict__ src,
                                       size_t stride, uint32_t (&x)[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    x[k] = (uint32_t)src[(2 * k) * stride] |
           ((uint32_t)src[(2 * k + 1) * stride] << 16);
  }
}

template <int W>
__device__ __forceinline__ void store16(int32_t* __restrict__ dst,
                                        size_t stride, const uint32_t (&x)[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    dst[(2 * k) * stride] = (int32_t)(x[k] & 0xffffu);
    dst[(2 * k + 1) * stride] = (int32_t)(x[k] >> 16);
  }
}

// 32-bit words that a block writes and reads back in one launch (the plan
// kernel's shared-memory slots), `stride` words apart.
template <int W>
__device__ __forceinline__ void load32(const uint32_t* src, int stride,
                                       uint32_t (&x)[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) x[k] = src[k * stride];
}

template <int W>
__device__ __forceinline__ void store32(uint32_t* dst, int stride,
                                        const uint32_t (&x)[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) dst[k * stride] = x[k];
}

template <int N>
__device__ __forceinline__ void zero_wide(uint32_t (&t)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = 0;
}

// acc[0..2W] += a * b (schoolbook product, then one carry chain into acc).
template <int W>
__device__ __forceinline__ void mul_acc(uint32_t (&acc)[2 * W + 1],
                                        const uint32_t (&a)[W],
                                        const uint32_t (&b)[W]) {
  uint32_t prod[2 * W];
#pragma unroll
  for (int i = 0; i < 2 * W; ++i) prod[i] = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      // (2^32-1)^2 + 2 (2^32-1) = 2^64 - 1: never overflows
      u64 s = (u64)a[i] * b[j] + prod[i + j] + c;
      prod[i + j] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
    prod[i + W] = c;  // first write of this word
  }
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < 2 * W; ++i) {
    u64 s = (u64)acc[i] + prod[i] + c;
    acc[i] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
  acc[2 * W] += c;
}

// t = a^2 as 2W words (+ one zero word): off-diagonal products once,
// doubled, then the diagonal squares.
template <int W>
__device__ __forceinline__ void sqr_wide(const uint32_t (&a)[W],
                                         uint32_t (&t)[2 * W + 1]) {
  zero_wide(t);
#pragma unroll
  for (int i = 0; i < W - 1; ++i) {
    uint32_t c = 0;
#pragma unroll
    for (int j = i + 1; j < W; ++j) {
      u64 s = (u64)a[i] * a[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
    t[i + W] = c;  // first write of this word
  }
  // double: the off-diagonal sum is < a^2 / 2 < 2^(64 W - 1)
#pragma unroll
  for (int i = 2 * W - 1; i > 0; --i) t[i] = (t[i] << 1) | (t[i - 1] >> 31);
  t[0] <<= 1;
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    u64 sq = (u64)a[i] * a[i];
    u64 s = (u64)t[2 * i] + (uint32_t)sq + c;
    t[2 * i] = (uint32_t)s;
    u64 s2 = (u64)t[2 * i + 1] + (sq >> 32) + (s >> 32);
    t[2 * i + 1] = (uint32_t)s2;
    c = (uint32_t)(s2 >> 32);
  }
  t[2 * W] = c;
}

// r = t R^-1 mod p, canonical, for t < p R (so that the reduced value is
// < 2p and one conditional subtraction finishes): W rounds with 32-bit
// digits m = t_i * N0; each round's carry out of word i+W is kept in `top`
// and added at word i+W+1 in the next round.
template <class F>
__device__ __forceinline__ void mont_reduce(uint32_t (&t)[2 * F::W + 1],
                                            uint32_t (&r)[F::W]) {
  constexpr int W = F::W;
  uint32_t top = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint32_t m = t[i] * F::N0;
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      u64 s = (u64)m * F::p(j) + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
    u64 s = (u64)t[i + W] + c + top;
    t[i + W] = (uint32_t)s;
    top = (uint32_t)(s >> 32);
  }
  // value = t[W..2W-1] (+ top 2^(32 W), which is 0 since the value is < 2p)
  uint32_t d[W];
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    u64 s = (u64)t[W + j] - F::p(j) - br;
    d[j] = (uint32_t)s;
    br = (uint32_t)(s >> 63);
  }
  const bool ge = (br == 0) || (top != 0);
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = ge ? d[j] : t[W + j];
}

// r = a b R^-1 mod p (r may be a or b).
template <class F>
__device__ __forceinline__ void mont_mul(const uint32_t (&a)[F::W],
                                         const uint32_t (&b)[F::W],
                                         uint32_t (&r)[F::W]) {
  uint32_t t[2 * F::W + 1];
  zero_wide(t);
  mul_acc(t, a, b);
  mont_reduce<F>(t, r);
}

// r = a^2 R^-1 mod p (r may be a): sqr_wide, the sqr kernel's body.
template <class F>
__device__ __forceinline__ void mont_sqr(const uint32_t (&a)[F::W],
                                         uint32_t (&r)[F::W]) {
  uint32_t t[2 * F::W + 1];
  sqr_wide(a, t);
  mont_reduce<F>(t, r);
}

// r = (a + b) mod p
template <class F>
__device__ __forceinline__ void mod_add(const uint32_t (&a)[F::W],
                                        const uint32_t (&b)[F::W],
                                        uint32_t (&r)[F::W]) {
  constexpr int W = F::W;
  uint32_t s[W];
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    u64 x = (u64)a[j] + b[j] + c;
    s[j] = (uint32_t)x;
    c = (uint32_t)(x >> 32);
  }
  uint32_t d[W];
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    u64 x = (u64)s[j] - F::p(j) - br;
    d[j] = (uint32_t)x;
    br = (uint32_t)(x >> 63);
  }
  const bool take = (c != 0) || (br == 0);
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = take ? d[j] : s[j];
}

// r = (a - b) mod p: subtract, and add p back on a borrow.
template <class F>
__device__ __forceinline__ void mod_sub(const uint32_t (&a)[F::W],
                                        const uint32_t (&b)[F::W],
                                        uint32_t (&r)[F::W]) {
  constexpr int W = F::W;
  uint32_t d[W];
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    u64 x = (u64)a[j] - b[j] - br;
    d[j] = (uint32_t)x;
    br = (uint32_t)(x >> 63);
  }
  const uint32_t mask = 0u - br;
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    u64 x = (u64)d[j] + (F::p(j) & mask) + c;
    r[j] = (uint32_t)x;
    c = (uint32_t)(x >> 32);
  }
}

constexpr int kSopBlock = 128;

// One lane of a T-term sum of products: row_a(t) and row_b(t) point at the
// first 16-bit limb of term t's operands (limbs `stride` elements apart);
// the T products are summed in a 2W+1-word accumulator, then one reduction
// writes the canonical (sum_t a_t b_t) R^-1 mod p to dst.  T <= MAX_TERMS.
template <class F, class RowA, class RowB>
__device__ __forceinline__ void sop_lane(RowA row_a, RowB row_b, int T,
                                         size_t stride,
                                         int32_t* __restrict__ dst) {
  constexpr int W = F::W;
  uint32_t acc[2 * W + 1];
  zero_wide(acc);
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    uint32_t x[W], y[W];
    load16(row_a(t), stride, x);
    load16(row_b(t), stride, y);
    mul_acc(acc, x, y);
  }
  uint32_t r[W];
  mont_reduce<F>(acc, r);
  store16(dst, stride, r);
}

// out[:, b] = (sum_t a[t, :, b] * b[t, :, b]) R^-1 mod p over int32 16-bit
// limbs [T, L16, B] -> [L16, B], T <= MAX_TERMS: one thread per lane.
template <class F>
__global__ void __launch_bounds__(kSopBlock)
sop_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
           int32_t* __restrict__ out, int T, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t term = (size_t)F::L16 * B;
  sop_lane<F>([&](int t) { return a + t * term + lane; },
              [&](int t) { return b + t * term + lane; }, T, B, out + lane);
}

// Launch sop_kernel<F> on `stream`; returns cudaGetLastError().
template <class F>
int launch_sop(const void* a, const void* b, void* out, int T, int B,
               void* stream) {
  if (T < 1 || T > F::MAX_TERMS || B < 1) return (int)cudaErrorInvalidValue;
  const int grid = (B + kSopBlock - 1) / kSopBlock;
  sop_kernel<F><<<grid, kSopBlock, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, T, B);
  return (int)cudaGetLastError();
}

// Fixed-exponent power: the JAX package's `limbs.pow_fixed` chain (a scan of
// sqr_pallas and sop_pallas launches, limbs.py:693) in one launch.  The
// exponent's 4-bit digits, most significant first, travel by value in the
// launch's parameter block (every thread reads the same digit: a broadcast
// from the constant cache).  One thread per lane runs the whole chain with
// the accumulator in registers; its 16-entry window table (R mod p, a, a^2
// .. a^15) lives in shared memory, word-major with the lane innermost, so a
// warp's reads of one word fall in 32 banks.  Every step returns the
// canonical value, so skipping the leading zero digits and the products by
// entry 0 (R mod p) keeps the JAX schedule's result.  Bound: the chain of
// dependent products per lane (latency), not the 2 L16 words it moves.
constexpr int kPowDigits = 256;  // 1024-bit exponents
constexpr int kPowLanes = 128;   // lanes (threads) per block

struct PowDigits {
  uint8_t d[kPowDigits];
};

template <class F>
__global__ void __launch_bounds__(kPowLanes)
pow_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
           int n_digits, int B, const __grid_constant__ PowDigits e) {
  constexpr int W = F::W, n = kPowLanes;
  constexpr int entry = W * n;  // words from one table entry to the next
  extern __shared__ uint32_t table[];  // [16][W][kPowLanes]
  const int lane = blockIdx.x * n + threadIdx.x;
  if (lane >= B) return;  // lanes share no data: no barrier follows
  uint32_t* mine = table + threadIdx.x;
  uint32_t base[W], x[W];
#pragma unroll
  for (int j = 0; j < W; ++j) x[j] = F::one(j);
  store32(mine, n, x);
  load16(a + lane, B, base);
#pragma unroll
  for (int j = 0; j < W; ++j) x[j] = base[j];
  store32(mine + entry, n, x);
#pragma unroll 1
  for (int k = 2; k < 16; ++k) {
    mont_mul<F>(x, base, x);
    store32(mine + k * entry, n, x);
  }
  int i = 0;
  while (i < n_digits && e.d[i] == 0) ++i;
  uint32_t acc[W];
  load32(mine + (i < n_digits ? e.d[i] : 0) * entry, n, acc);
#pragma unroll 1
  for (++i; i < n_digits; ++i) {
#pragma unroll
    for (int s = 0; s < 4; ++s) mont_sqr<F>(acc, acc);
    const int d = e.d[i];
    if (d != 0) {
      load32(mine + d * entry, n, x);
      mont_mul<F>(acc, x, acc);
    }
  }
  store16(out + lane, B, acc);
}

// Launch pow_kernel<F> on `stream`; digits: n_digits host bytes, each < 16.
// Returns cudaGetLastError() (or the error of raising the shared-memory
// cap).
template <class F>
int launch_pow(const void* a, void* out, const uint8_t* digits, int n_digits,
               int B, void* stream) {
  if (n_digits < 0 || n_digits > kPowDigits || B < 1)
    return (int)cudaErrorInvalidValue;
  PowDigits e = {};
  for (int i = 0; i < n_digits; ++i) {
    if (digits[i] > 15) return (int)cudaErrorInvalidValue;
    e.d[i] = digits[i];
  }
  constexpr int smem = 16 * F::W * (int)sizeof(uint32_t) * kPowLanes;
  if (smem > 48 * 1024) {  // above 48 KB only after raising the cap
    const cudaError_t err = cudaFuncSetAttribute(
        pow_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (B + kPowLanes - 1) / kPowLanes;
  pow_kernel<F><<<grid, kPowLanes, smem, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)out, n_digits, B, e);
  return (int)cudaGetLastError();
}

}  // namespace montgomery
