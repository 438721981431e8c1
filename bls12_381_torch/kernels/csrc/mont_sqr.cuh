// Montgomery squares in the BLS12-381 base field on Hopper (wrapper and
// plain version: kernels/mont.py `sqr`, `sqr_plain`).
//
//   out[g, :, b] = a[g, :, b]^2 R^-1 mod p, canonical, R = 2^384; a and out
//   int32 [G, 24, B], 16-bit limbs in Montgomery form, a canonical.
//
// Replaces bls12_381_tpu/kernels/pallas_mont.py:711 `sqr_pallas` (default
// body `_sqr_kernel_r12_scalar`): G independent squares per launch, one
// lane each.
//
// What bounds it.  Per lane the kernel reads 96 bytes and writes 96 and
// runs ~460 32-bit multiplies (the 66 off-diagonal and 12 diagonal word
// products, lo and hi, and the reduction's 144): at the paths' widths (512
// to 1024 lanes, 4 to 8 blocks of 132 SMs) the time is one lane's chain of
// dependent instructions plus the launch, about 2 us of the ~3 (the
// earlier kernel, a 64-bit-carry square, since deleted); at 2^20 lanes the
// bytes bound it (192 MB at 3.35 TB/s: 0.060 ms, the multiplies at the
// card's 32-bit rate 0.029 ms).
//
// The design.  One thread squares one lane with its additions riding the
// hardware carry flag (carry_chain.cuh `sqr_words_of`, the square of the Fp
// and Fr power's single-thread shape too):
// 1. The off-diagonal products a_i a_j, i < j, row by row: the products
//    with j - i odd fill disjoint word pairs starting at the odd column
//    2i + 1 and go to accumulator A in one carry chain, those with j - i
//    even pairs starting at the even column 2i + 2 and go to B in another,
//    two chains side by side (mad_pairs, 11 + 10 rows).
// 2. A + B (two 12-word add chains), doubled by one funnel shift a word
//    (no carries), then the diagonal squares added in two chains.
// 3. The Montgomery reduction of the low half, as fp2_pow.cuh's `mont_sum`
//    reduces: per row m = (A[0] + B[0] + carry) N0 and m p's even and odd
//    words in two carry chains, both low words dropped and their sum (0 or
//    2^32) carried into the next row; then the high half added and one
//    conditional subtraction.
// Each intermediate's bound is stated beside the code;
// tests/test_torch_sqr_model.py runs the same rows on Python integers and
// asserts them.  Launch shape: kThreads threads a block, kLanesPerThread
// lanes a thread (chip_smoke.py times it, scripts/xmd_sqr_variants.py the
// others; PERF.md).  montgomery.cuh's 64-bit-carry mont_reduce is not used
// here.
#pragma once

#include "carry_chain.cuh"
#include "montgomery.cuh"

namespace montsqr {

using carry::W;

// the library's launch shape (mont.py SQR_THREADS, SQR_LANES_PER_THREAD)
constexpr int kThreads = 128;       // threads per block
constexpr int kLanesPerThread = 1;  // squares per thread

// r = a^2 R^-1 mod p, canonical, for a < p (r may be a).
__device__ __forceinline__ void sqr_words(const uint32_t (&a)[W],
                                          uint32_t (&r)[W]) {
  carry::sqr_words_of<fp384::Field, true>(a, r);
}

// kPer lanes per thread, kPer * gridDim.x * kT apart: independent squares
// whose chains the scheduler interleaves.
template <int kT, int kPer>
__global__ void __launch_bounds__(kT)
sqr_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out, int G,
           int B) {
  const long long n = (long long)G * B;
  const long long stride = (long long)gridDim.x * kT;
  const long long first = (long long)blockIdx.x * kT + threadIdx.x;
  uint32_t x[kPer][W];
  size_t off[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long idx = first + k * stride;
    const long long g = idx / B;
    off[k] = (size_t)g * 2 * W * B + (size_t)(idx - g * B);
    if (idx < n) montgomery::load16(a + off[k], B, x[k]);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (first + k * stride < n) {
      sqr_words(x[k], x[k]);
      montgomery::store16(out + off[k], B, x[k]);
    }
  }
}

// Launch sqr_kernel<kT, kPer> on `stream`.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for G or B < 1.  static: each library that holds
// this header launches its own instance.
template <int kT, int kPer>
static int launch_sqr_shape(const void* a, void* out, int G, int B, void* stream) {
  if (G < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)G * B;
  const long long per_block = (long long)kT * kPer;
  const long long grid = (n + per_block - 1) / per_block;
  sqr_kernel<kT, kPer><<<(unsigned)grid, kT, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)out, G, B);
  return (int)cudaGetLastError();
}

// The library's shape.
static int launch_sqr(const void* a, void* out, int G, int B, void* stream) {
  return launch_sqr_shape<kThreads, kLanesPerThread>(a, out, G, B, stream);
}

}  // namespace montsqr
