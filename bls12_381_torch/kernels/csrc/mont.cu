// Montgomery sum-of-products, squaring, planned-fold and fixed-exponent power
// kernels for the BLS12-381 base field (wrappers and notes: kernels/mont.py).
//
//   bls_sop: out[:, b] = (sum_t a[t, :, b] * b[t, :, b]) R^-1 mod p,
//            a, b int32 [T, 24, B] 16-bit limbs, T <= 8; out int32 [24, B]
//            (montgomery.cuh's sop_kernel for Fp)
//   bls_sqr: out[g, :, b] = a[g, :, b]^2 R^-1 mod p, int32 [G, 24, B]
//   bls_fold_planned:
//            out[g, :, b] = (sum_t ops[ia[g,t], :, b] * ops[ib[g,t], :, b])
//                           R^-1 mod p,
//            ops int32 [K, 24, B] (row 0 zeros: short groups pad with index
//            0), ia/ib host int32 [G, T] tables, T <= 8, G T <= kFoldEntries;
//            out int32 [G, 24, B]
//   bls_pow_fixed:
//            out[:, b] = a[:, b]^e R^(1-e) mod p (the Montgomery form of a^e),
//            a int32 [24, B]; e as n_digits host uint8 4-bit digits, most
//            significant first, n_digits <= 256 (montgomery.cuh's pow_kernel
//            for Fp)
//
// One thread per (group,) lane; the C functions launch on the given stream
// and return cudaGetLastError().
#include "fp384.cuh"

using namespace montgomery;
using fp384::Field;

// Entries of the [G, T] index tables the fold kernel takes by value.
constexpr int kFoldEntries = 512;

namespace {

constexpr int kBlock = 128;

// The fold's index tables travel in the launch's parameter block (2 KB), so
// no call copies them to the device; every thread of a block reads the same
// entries, a broadcast from the constant cache.
struct FoldTable {
  uint16_t ia[kFoldEntries];
  uint16_t ib[kFoldEntries];
};

// Group g = blockIdx.y, lanes on x: a warp's loads of one limb row are 32
// neighbouring words; each distinct operand row is read once per group
// that names it (the L2 serves the repeats).
__global__ void __launch_bounds__(kBlock)
fold_kernel(const int32_t* __restrict__ ops, int32_t* __restrict__ out,
            int T, int B, const __grid_constant__ FoldTable tab) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t row = (size_t)Field::L16 * B;
  const int base = blockIdx.y * T;
  sop_lane<Field>([&](int t) { return ops + tab.ia[base + t] * row + lane; },
                  [&](int t) { return ops + tab.ib[base + t] * row + lane; },
                  T, B, out + blockIdx.y * row + lane);
}

__global__ void __launch_bounds__(kBlock)
sqr_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out, int G,
           int B) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)G * B) return;
  const int g = (int)(idx / B), lane = (int)(idx % B);
  const size_t off = (size_t)g * Field::L16 * B + lane;
  uint32_t x[Field::W];
  load16(a + off, B, x);
  mont_sqr<Field>(x, x);
  store16(out + off, B, x);
}

}  // namespace

extern "C" int bls_sop(const void* a, const void* b, void* out, int T, int B,
                       void* stream) {
  return launch_sop<Field>(a, b, out, T, B, stream);
}

extern "C" int bls_sqr(const void* a, void* out, int G, int B, void* stream) {
  if (G < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)G * B;
  const int grid = (int)((n + kBlock - 1) / kBlock);
  sqr_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (int32_t*)out, G, B);
  return (int)cudaGetLastError();
}

extern "C" int bls_pow_fixed(const void* a, void* out, const uint8_t* digits,
                             int n_digits, int B, void* stream) {
  return launch_pow<Field>(a, out, digits, n_digits, B, stream);
}

extern "C" int bls_fold_planned(const void* ops, const int32_t* ia,
                                const int32_t* ib, void* out, int K, int G,
                                int T, int B, void* stream) {
  if (K < 1 || K > 65536 || G < 1 || G > 65535 || T < 1 ||
      T > Field::MAX_TERMS || G * T > kFoldEntries || B < 1)
    return (int)cudaErrorInvalidValue;
  FoldTable tab = {};
  for (int i = 0; i < G * T; ++i) {
    if (ia[i] < 0 || ia[i] >= K || ib[i] < 0 || ib[i] >= K)
      return (int)cudaErrorInvalidValue;
    tab.ia[i] = (uint16_t)ia[i];
    tab.ib[i] = (uint16_t)ib[i];
  }
  const dim3 grid((B + kBlock - 1) / kBlock, G);
  fold_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ops, (int32_t*)out, T, B, tab);
  return (int)cudaGetLastError();
}
