// 256-bit Montgomery arithmetic for the BLS12-381 scalar field Fr on Hopper.
//
// The field struct of the port's Fr kernels (fr.cu), which instantiate the
// word-level code of montgomery.cuh with it.  An Fr element lives in
// registers as 8 little-endian 32-bit words, in Montgomery form with
// R = 2^256 (the same R as the 16 16-bit limbs at the boundary).  R/q ~ 2.21,
// so a fused sum of products reduces to a canonical value for T <= 2 terms,
// and 2q < 2^256, so a modular add never carries out of the 8 words.
#pragma once

#include "montgomery.cuh"

namespace fr256 {

static __constant__ uint32_t kQ[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u,
};

// R mod q: one in Montgomery form
static __constant__ uint32_t kOne[8] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
    0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u,
};

struct Field {
  static constexpr int W = 8;          // 32-bit words per element
  static constexpr int L16 = 16;       // 16-bit limbs at the boundary
  static constexpr int MAX_TERMS = 2;  // T q < R
  static constexpr uint32_t N0 = 0xffffffffu;  // -q^-1 mod 2^32 (q's low word is 1)
  // 4q > R (q ~ 0.45 R): a product of two values below 2q can reach 2.8q,
  // so mont_pow.cuh keeps the power's Fr values canonical at every step
  static constexpr bool kLazy = false;
  __device__ __forceinline__ static uint32_t p(int j) { return kQ[j]; }
  // word j of q as an immediate, for j known at compile time
  __device__ __forceinline__ static uint32_t word(int j) {
    constexpr uint32_t w[W] = {
        0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
        0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
    return w[j];
  }
  __device__ __forceinline__ static uint32_t one(int j) { return kOne[j]; }
};

}  // namespace fr256
