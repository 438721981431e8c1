// Montgomery sum-of-products and squaring kernels for the BLS12-381 base
// field (wrappers and notes: kernels/mont.py).
//
//   bls_sop: out[:, b] = (sum_t a[t, :, b] * b[t, :, b]) R^-1 mod p,
//            a, b int32 [T, 24, B] 16-bit limbs, T <= 8; out int32 [24, B]
//   bls_sqr: out[g, :, b] = a[g, :, b]^2 R^-1 mod p, int32 [G, 24, B]
//
// One thread per (group,) lane; the C functions launch on the given stream
// and return cudaGetLastError().
#include "fp384.cuh"

using namespace fp384;

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
sop_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
           int32_t* __restrict__ out, int T, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t acc[2 * W + 1];
  zero_wide(acc);
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const size_t off = (size_t)t * L16 * B + lane;
    uint32_t x[W], y[W];
    load16(a + off, B, x);
    load16(b + off, B, y);
    mul_acc(acc, x, y);
  }
  uint32_t r[W];
  mont_reduce(acc, r);
  store16(out + lane, B, r);
}

__global__ void __launch_bounds__(kBlock)
sqr_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out, int G,
           int B) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)G * B) return;
  const int g = (int)(idx / B), lane = (int)(idx % B);
  const size_t off = (size_t)g * L16 * B + lane;
  uint32_t x[W];
  load16(a + off, B, x);
  uint32_t t[2 * W + 1];
  sqr_wide(x, t);
  uint32_t r[W];
  mont_reduce(t, r);
  store16(out + off, B, r);
}

}  // namespace

extern "C" int bls_sop(const void* a, const void* b, void* out, int T, int B,
                       void* stream) {
  if (T < 1 || T > 8 || B < 1) return (int)cudaErrorInvalidValue;
  const int grid = (B + kBlock - 1) / kBlock;
  sop_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, T, B);
  return (int)cudaGetLastError();
}

extern "C" int bls_sqr(const void* a, void* out, int G, int B, void* stream) {
  if (G < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)G * B;
  const int grid = (int)((n + kBlock - 1) / kBlock);
  sqr_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)out, G, B);
  return (int)cudaGetLastError();
}
