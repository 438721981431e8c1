// 384-bit Montgomery arithmetic for the BLS12-381 base field on Hopper.
//
// The field struct of the port's Fp kernels (mont.cu, plan_exec.cu), which
// instantiate the word-level code of montgomery.cuh with it.  An Fp element
// lives in registers as 12 little-endian 32-bit words, in Montgomery form
// with R = 2^384.
#pragma once

#include "montgomery.cuh"

namespace fp384 {

static __constant__ uint32_t kP[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau,
};

// R mod p: one in Montgomery form
static __constant__ uint32_t kOne[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu,
    0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u,
    0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u,
};

struct Field {
  static constexpr int W = 12;         // 32-bit words per element
  static constexpr int L16 = 24;       // 16-bit limbs at the boundary
  static constexpr int MAX_TERMS = 8;  // R/p ~ 9.84
  static constexpr uint32_t N0 = 0xfffcfffdu;  // -p^-1 mod 2^32
  // 4p < R: a Montgomery product of two values below 2p is below 2p with no
  // subtraction (mont_pow.cuh keeps the power's values lazy)
  static constexpr bool kLazy = true;
  __device__ __forceinline__ static uint32_t p(int j) { return kP[j]; }
  // word j of p as an immediate, for j known at compile time
  __device__ __forceinline__ static uint32_t word(int j) {
    constexpr uint32_t w[W] = {
        0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
        0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
        0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
    return w[j];
  }
  __device__ __forceinline__ static uint32_t one(int j) { return kOne[j]; }
};

}  // namespace fp384
