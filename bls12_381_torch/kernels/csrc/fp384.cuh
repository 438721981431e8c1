// 384-bit Montgomery arithmetic for the BLS12-381 base field on Hopper.
//
// Shared device code of the port's kernels (mont.cu, plan_exec.cu).  An Fp
// element lives in registers as 12 little-endian 32-bit words, in Montgomery
// form with R = 2^384 -- the same R as the 16-bit limbs at the boundary, so
// repacking cannot change a canonical value.  Every function returns a
// canonical result (< p) from canonical inputs.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fp384 {

typedef unsigned long long u64;

constexpr int W = 12;    // 32-bit words per element
constexpr int L16 = 24;  // 16-bit limbs per element at the boundary
constexpr uint32_t N0 = 0xfffcfffdu;  // -p^-1 mod 2^32

static __constant__ uint32_t kP[W] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau,
};

// x[k] = limb[2k] | limb[2k+1] << 16, reading 16-bit limbs stored in int32
// with `stride` elements between consecutive limbs (the batch size).
__device__ __forceinline__ void load16(const int32_t* __restrict__ src,
                                       size_t stride, uint32_t x[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    x[k] = (uint32_t)src[(2 * k) * stride] |
           ((uint32_t)src[(2 * k + 1) * stride] << 16);
  }
}

__device__ __forceinline__ void store16(int32_t* __restrict__ dst,
                                        size_t stride, const uint32_t x[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) {
    dst[(2 * k) * stride] = (int32_t)(x[k] & 0xffffu);
    dst[(2 * k + 1) * stride] = (int32_t)(x[k] >> 16);
  }
}

// Scratch that a thread writes and reads back in one launch: plain
// (coherent) pointers, never the read-only data path.
__device__ __forceinline__ void load32(const uint32_t* src,
                                       size_t stride, uint32_t x[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) x[k] = src[k * stride];
}

__device__ __forceinline__ void store32(uint32_t* dst,
                                        size_t stride, const uint32_t x[W]) {
#pragma unroll
  for (int k = 0; k < W; ++k) dst[k * stride] = x[k];
}

__device__ __forceinline__ void zero_wide(uint32_t t[2 * W + 1]) {
#pragma unroll
  for (int i = 0; i < 2 * W + 1; ++i) t[i] = 0;
}

// acc[0..2W] += a * b (schoolbook product, then one carry chain into acc).
__device__ __forceinline__ void mul_acc(uint32_t acc[2 * W + 1],
                                        const uint32_t a[W],
                                        const uint32_t b[W]) {
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
__device__ __forceinline__ void sqr_wide(const uint32_t a[W],
                                         uint32_t t[2 * W + 1]) {
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
  // double: the off-diagonal sum is < a^2 / 2 < 2^767
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
// < 2p and one conditional subtraction finishes): 12 rounds with 32-bit
// digits m = t_i * N0; each round's carry out of word i+W is kept in `top`
// and added at word i+W+1 in the next round.
__device__ __forceinline__ void mont_reduce(uint32_t t[2 * W + 1],
                                            uint32_t r[W]) {
  uint32_t top = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint32_t m = t[i] * N0;
    uint32_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      u64 s = (u64)m * kP[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = (uint32_t)(s >> 32);
    }
    u64 s = (u64)t[i + W] + c + top;
    t[i + W] = (uint32_t)s;
    top = (uint32_t)(s >> 32);
  }
  // value = t[W..2W-1] (+ top 2^384, which is 0 since the value is < 2p)
  uint32_t d[W];
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    u64 s = (u64)t[W + j] - kP[j] - br;
    d[j] = (uint32_t)s;
    br = (uint32_t)(s >> 63);
  }
  const bool ge = (br == 0) || (top != 0);
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = ge ? d[j] : t[W + j];
}

// r = (a + b) mod p
__device__ __forceinline__ void mod_add(const uint32_t a[W],
                                        const uint32_t b[W], uint32_t r[W]) {
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
    u64 x = (u64)s[j] - kP[j] - br;
    d[j] = (uint32_t)x;
    br = (uint32_t)(x >> 63);
  }
  const bool take = (c != 0) || (br == 0);
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = take ? d[j] : s[j];
}

// r = (a - b) mod p: subtract, and add p back on a borrow.
__device__ __forceinline__ void mod_sub(const uint32_t a[W],
                                        const uint32_t b[W], uint32_t r[W]) {
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
    u64 x = (u64)d[j] + (kP[j] & mask) + c;
    r[j] = (uint32_t)x;
    c = (uint32_t)(x >> 32);
  }
}

}  // namespace fp384
