// Montgomery sum-of-products, squaring and fixed-exponent power kernels for
// the BLS12-381 base field (wrappers and notes: kernels/mont.py).
//
//   bls_sop_rows: out[g, :, b] = (sum_{t < n_g} row[ia[g,t]][:, b]
//                                 * row[ib[g,t]][:, b]) R^-1 mod p,
//            G groups of n_g <= 8 terms over a host table of rows (device
//            pointer and element strides: each operand read where the caller
//            holds it); out int32 [G, 24, B] (montgomery.cuh's
//            sop_rows_kernel for Fp: the wrappers `sop`, `fold_planned` and
//            `sop_rows`)
//   bls_sop_rows_param_bytes: parameter bytes of the capacity a call of
//            n_rows rows and G T table entries launches with (-1: none)
//   bls_sqr: out[g, :, b] = a[g, :, b]^2 R^-1 mod p, int32 [G, 24, B]
//            (mont_sqr.cuh's sqr_kernel: one thread per lane, carry-flag
//            chains)
//   bls_pow_fixed:
//            out[:, b] = a[:, b]^e R^(1-e) mod p (the Montgomery form of a^e),
//            a int32 [24, B]; e as n_digits host uint8 4-bit digits, most
//            significant first, n_digits <= 256 (mont_pow.cuh's
//            mont_pow_kernel for Fp: 4, 2 or 1 threads per lane by the
//            width, carry-flag products, values below 2p between steps)
//   bls_fp2_pow_fixed:
//            (out0 + out1 u)[:, b] = (a0 + a1 u)[:, b]^e in Fp2 = Fp[u]/(u^2+1),
//            Montgomery form, a0, a1, out0, out1 int32 [24, B]; e as for
//            bls_pow_fixed (fp2_pow.cuh's fp2_pow_kernel: two threads per
//            lane, fp2pow::kLanes lanes per block)
//
// The C functions launch on the given stream and return cudaGetLastError().
#include "fp2_pow.cuh"
#include "fp384.cuh"
#include "mont_pow.cuh"
#include "mont_sqr.cuh"

using namespace montgomery;
using fp384::Field;

extern "C" int bls_sop_rows(const SopRow* rows, int n_rows,
                            const uint16_t* ia, const uint16_t* ib,
                            const uint8_t* counts, void* out, int G, int T,
                            int B, int n_inner, int lt, int gpb, int split,
                            void* stream) {
  return launch_sop_rows<Field>(rows, n_rows, ia, ib, counts, out, G, T, B,
                                n_inner, lt, gpb, split, stream);
}

extern "C" int bls_sop_rows_param_bytes(int n_rows, int entries) {
  return sop_rows_param_bytes(n_rows, entries);
}

extern "C" int bls_sqr(const void* a, void* out, int G, int B, void* stream) {
  return montsqr::launch_sqr(a, out, G, B, stream);
}

extern "C" int bls_pow_fixed(const void* a, void* out, const uint8_t* digits,
                             int n_digits, int B, void* stream) {
  return montpow::launch_pow<Field>(a, out, digits, n_digits, B, stream);
}

extern "C" int bls_fp2_pow_fixed(const void* a0, const void* a1, void* out0,
                                 void* out1, const uint8_t* digits,
                                 int n_digits, int B, void* stream) {
  return fp2pow::launch_fp2_pow(a0, a1, out0, out1, digits, n_digits, B,
                                stream);
}
