// Montgomery sum-of-products, NTT butterfly and fixed-exponent power kernels
// for the BLS12-381 scalar field Fr (wrappers and notes: kernels/mont.py).
//
//   bls_sop_rows_fr: out[g, :, b] = (sum_{t < n_g} row[ia[g,t]][:, b]
//                  * row[ib[g,t]][:, b]) R^-1 mod q, G groups of n_g <= 2
//                  terms over a host table of rows (device pointer and
//                  element strides); out int32 [G, 16, B] (montgomery.cuh's
//                  sop_rows_kernel for Fr: the wrappers `sop_fr`, `sop_rows`)
//   bls_butterfly: t = b w R^-1 mod q; out[0] = a + t, out[1] = a - t mod q,
//                  a, b, w int32 [16, B]; out int32 [2, 16, B]
//   bls_pow_fixed_fr: out[:, b] = a[:, b]^e R^(1-e) mod q, a int32 [16, B];
//                  e as n_digits <= 256 host uint8 4-bit digits, most
//                  significant first (mont_pow.cuh's mont_pow_kernel for
//                  Fr: the Fp power's design, 2 or 1 threads per lane by
//                  the width, every step canonical)
//
// The C functions launch on the given stream and return cudaGetLastError().
#include "fr256.cuh"
#include "mont_pow.cuh"

using namespace montgomery;
using fr256::Field;

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
butterfly_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                 const int32_t* __restrict__ w, int32_t* __restrict__ out,
                 int B) {
  constexpr int W = Field::W;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t x[W], y[W];
  load16(b + lane, B, x);
  load16(w + lane, B, y);
  uint32_t acc[2 * W + 1];
  zero_wide(acc);
  mul_acc(acc, x, y);
  uint32_t t[W];
  mont_reduce<Field>(acc, t);  // t = b w R^-1 mod q, canonical
  load16(a + lane, B, x);
  uint32_t r[W];
  mod_add<Field>(x, t, r);
  store16(out + lane, B, r);
  mod_sub<Field>(x, t, r);
  store16(out + (size_t)Field::L16 * B + lane, B, r);
}

}  // namespace

extern "C" int bls_sop_rows_fr(const SopRow* rows, int n_rows,
                               const uint16_t* ia, const uint16_t* ib,
                               const uint8_t* counts, void* out, int G, int T,
                               int B, int n_inner, int lt, int gpb, int split,
                               void* stream) {
  return launch_sop_rows<Field>(rows, n_rows, ia, ib, counts, out, G, T, B,
                                n_inner, lt, gpb, split, stream);
}

extern "C" int bls_pow_fixed_fr(const void* a, void* out,
                                const uint8_t* digits, int n_digits, int B,
                                void* stream) {
  return montpow::launch_pow<Field>(a, out, digits, n_digits, B, stream);
}

extern "C" int bls_butterfly(const void* a, const void* b, const void* w,
                             void* out, int B, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  const int grid = (B + kBlock - 1) / kBlock;
  butterfly_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (const int32_t*)w,
      (int32_t*)out, B);
  return (int)cudaGetLastError();
}
