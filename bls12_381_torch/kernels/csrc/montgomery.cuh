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
// These are the 64-bit-carry products: the row kernel at the end
// (instantiated once per field), the plan kernel (plan_exec.cu) and the
// butterfly (fr.cu) run them.  The carry-flag arithmetic of the square,
// the Fp2 power and the Fp and Fr power is carry_chain.cuh's (mont_sqr.cuh,
// fp2_pow.cuh, mont_pow.cuh); the power kernels' parameters are at the
// end.
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

// ---------------------------------------------------------------------------
// Sums of products over a row table: the port's one sum-of-products kernel
// (the TPU kernels sop_pallas and fold_planned_pallas; wrappers, plain
// version and launch shape: kernels/mont.py `sop_rows`).
//
// out[g] = (sum_{t < n_g} row[ia[g, t]] row[ib[g, t]]) R^-1 mod p, canonical,
// for G groups of n_g <= MAX_TERMS terms over B batch lanes, written to
// out[G][L16][B].  Each row is an operand where the caller holds it: limb k
// of lane l = o n + i (n the size of the batch's last axis) sits at
// ptr[k s_limb + o s_outer + i s_inner], so views (movedim, 0::2 slices) and
// broadcasts (a stride of 0) are read in place, with no copy before the
// launch.  The rows, the [G, T] index tables and the term counts travel by
// value in the launch's parameter block (__grid_constant__), so no call
// copies a table to the device; a thread reads its terms' entries and
// rows from the constant cache.  (Copying them into shared memory first,
// once per block, measured about 1 us slower per launch at the paths'
// shapes: the copy's divergent constant loads and the barrier cost more
// than they save.)  The block is Lt lanes
// (threadIdx.x) by gpb group slots x `split` threads per group
// (threadIdx.y): the groups of a call share each block, gpb at a time, so
// a row that several groups name is fetched from device memory once per
// lane tile and served from L1 after that.  Split threads take every
// split-th term of their group, add their 2W+1-word partial products in
// shared memory, and the group's first thread reduces and stores: the
// serial chain per thread is ceil(n_g / split) products, which is what sets
// the time of a narrow batch.
// ---------------------------------------------------------------------------

constexpr int kSopRowsThreads = 256;  // threads per block, at most

struct SopRow {
  const int32_t* ptr;  // limb 0 of lane 0
  int s_limb, s_outer, s_inner, pad;  // element strides, >= 0
};

// The launch's parameters at a capacity of R rows and E table entries (and
// so at most E groups); the launcher takes the smallest that holds a call.
template <int R, int E>
struct SopRowsArgs {
  int32_t* out;          // [G, L16, B]
  int G, T, B, n_inner;  // tables [G, T]; lane l = o n_inner + i
  int gpb, split;        // group slots per block, threads per group
  SopRow rows[R];
  uint16_t ia[E], ib[E];  // term t of group g at [g T + t], 0 past n_g
  uint8_t n[E];           // terms of group g, 1..T
};

// x[k] = limb 2k | limb 2k+1 << 16 of a row at one lane, through the
// read-only cache.
template <int W>
__device__ __forceinline__ void load_row(const SopRow& r, int o, int i,
                                         uint32_t (&x)[W]) {
  const int32_t* src =
      r.ptr + (long long)o * r.s_outer + (long long)i * r.s_inner;
  const long long s = r.s_limb;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    x[k] = (uint32_t)__ldg(src + 2 * k * s) |
           ((uint32_t)__ldg(src + (2 * k + 1) * s) << 16);
  }
}

// acc += the N words at src, `stride` words apart (one carry chain).
template <int N>
__device__ __forceinline__ void add_wide(uint32_t (&acc)[N],
                                         const uint32_t* src, int stride) {
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    u64 s = (u64)acc[k] + src[k * stride] + c;
    acc[k] = (uint32_t)s;
    c = (uint32_t)(s >> 32);
  }
}

template <class F, class A>
__global__ void __launch_bounds__(kSopRowsThreads)
sop_rows_kernel(const __grid_constant__ A p) {
  constexpr int W = F::W, N = 2 * W + 1;
  extern __shared__ uint32_t part[];  // [gpb][split - 1][N][Lt]
  const int lt = blockDim.x, x = threadIdx.x;
  const int lane = blockIdx.x * lt + x;
  const bool live = lane < p.B;
  const int o = live ? lane / p.n_inner : 0;
  const int i = live ? lane - o * p.n_inner : 0;
  const int slot = threadIdx.y / p.split, s = threadIdx.y - slot * p.split;
  uint32_t* parts = part + slot * (p.split - 1) * N * lt + x;
  // every thread runs every round: the barriers below are block-wide
  for (int g0 = 0; g0 < p.G; g0 += p.gpb) {
    const int g = g0 + slot;
    const bool on = live && g < p.G;
    uint32_t acc[N];
    zero_wide(acc);
    if (on) {
      const int base = g * p.T, n = p.n[g];
      // the first term's rows are fetched beside the count, not after it:
      // s < split <= T, and an entry past a count is 0, a valid row
      const SopRow ra = p.rows[p.ia[base + s]];
      const SopRow rb = p.rows[p.ib[base + s]];
      if (s < n) {
        uint32_t a[W], b[W];
        load_row(ra, o, i, a);
        load_row(rb, o, i, b);
        mul_acc(acc, a, b);
      }
#pragma unroll 1
      for (int t = s + p.split; t < n; t += p.split) {
        uint32_t a[W], b[W];
        load_row(p.rows[p.ia[base + t]], o, i, a);
        load_row(p.rows[p.ib[base + t]], o, i, b);
        mul_acc(acc, a, b);
      }
    }
    if (p.split > 1) {
      if (s > 0) store32(parts + (s - 1) * N * lt, lt, acc);
      __syncthreads();
      if (s == 0 && on) {
        for (int k = 1; k < p.split; ++k)
          add_wide(acc, parts + (k - 1) * N * lt, lt);
      }
      __syncthreads();  // the next round writes `part` again
    }
    if (s == 0 && on) {
      uint32_t r[W];
      mont_reduce<F>(acc, r);  // sum < T p^2 < p R: one subtraction
      store16(p.out + (size_t)g * F::L16 * p.B + lane, p.B, r);
    }
  }
}

// Fill the parameters at capacity A and launch; see launch_sop_rows.
template <class F, class A>
int launch_sop_rows_as(const SopRow* rows, int n_rows, const uint16_t* ia,
                       const uint16_t* ib, const uint8_t* counts, void* out,
                       int G, int T, int B, int n_inner, int lt, int gpb,
                       int split, void* stream) {
  if (sizeof(A) > 4096) {  // a parameter block above 4 KB: CUDA >= 12.1
    int driver = 0;
    if (cudaDriverGetVersion(&driver) != cudaSuccess || driver < 12010)
      return (int)cudaErrorNotSupported;
  }
  A p = {};
  p.out = (int32_t*)out;
  p.G = G, p.T = T, p.B = B, p.n_inner = n_inner, p.gpb = gpb,
  p.split = split;
  for (int r = 0; r < n_rows; ++r) p.rows[r] = rows[r];
  for (int g = 0; g < G; ++g) {  // entries past a count stay 0
    p.n[g] = counts[g];
    for (int t = g * T; t < g * T + counts[g]; ++t)
      p.ia[t] = ia[t], p.ib[t] = ib[t];
  }
  const size_t smem =
      (size_t)gpb * (split - 1) * (2 * F::W + 1) * lt * sizeof(uint32_t);
  const dim3 block(lt, gpb * split);
  const int grid = (B + lt - 1) / lt;
  sop_rows_kernel<F, A><<<grid, block, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The capacities: (rows, entries) = (16, 16) for a product of up to eight
// terms (496 bytes of parameters), (64, 128) for the paths' folds (2.2 KB),
// (1024, 512) for any table the wrappers pass (27 KB, CUDA >= 12.1).
#define SOP_ROWS_CAPS(X) X(16, 16) X(64, 128) X(1024, 512)

// Parameter bytes of the smallest capacity that holds a call, or -1.
inline int sop_rows_param_bytes(int n_rows, int entries) {
#define SOP_ROWS_FITS(R, E) \
  if (n_rows <= R && entries <= E) return (int)sizeof(SopRowsArgs<R, E>);
  SOP_ROWS_CAPS(SOP_ROWS_FITS)
#undef SOP_ROWS_FITS
  return -1;
}

// Launch sop_rows_kernel<F> on `stream` over host tables: rows[n_rows];
// ia, ib [G, T] (entries past a group's count are not read); counts[G];
// out [G, L16, B]; a block of lt lanes x gpb group slots x split threads.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernel does not take.
template <class F>
int launch_sop_rows(const SopRow* rows, int n_rows, const uint16_t* ia,
                    const uint16_t* ib, const uint8_t* counts, void* out,
                    int G, int T, int B, int n_inner, int lt, int gpb,
                    int split, void* stream) {
  if (n_rows < 1 || G < 1 || T < 1 || T > F::MAX_TERMS || B < 1 ||
      n_inner < 1 || B % n_inner != 0 || lt < 1 || gpb < 1 || gpb > G ||
      split < 1 || split > T || (long long)lt * gpb * split > kSopRowsThreads)
    return (int)cudaErrorInvalidValue;
  for (int g = 0; g < G; ++g) {
    if (counts[g] < 1 || counts[g] > T) return (int)cudaErrorInvalidValue;
    for (int t = 0; t < counts[g]; ++t)
      if (ia[g * T + t] >= n_rows || ib[g * T + t] >= n_rows)
        return (int)cudaErrorInvalidValue;
  }
#define SOP_ROWS_LAUNCH(R, E)                                              \
  if (n_rows <= R && G * T <= E)                                           \
    return launch_sop_rows_as<F, SopRowsArgs<R, E>>(                       \
        rows, n_rows, ia, ib, counts, out, G, T, B, n_inner, lt, gpb, split, \
        stream);
  SOP_ROWS_CAPS(SOP_ROWS_LAUNCH)
#undef SOP_ROWS_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The parameters of the fixed-exponent power kernels (mont_pow.cuh for Fp
// and Fr, fp2_pow.cuh for Fp2): the exponent's 4-bit digits, most
// significant first, by value in the launch's parameter block, and the
// coordinates' device pointers.
// ---------------------------------------------------------------------------
constexpr int kPowDigits = 256;  // 1024-bit exponents

struct PowDigits {
  uint8_t d[kPowDigits];
};

// The coordinates' device pointers, each int32 [L16, B] (one for Fp and
// Fr, two for Fp2).
struct PowIO {
  const int32_t* a[2];
  int32_t* out[2];
};

}  // namespace montgomery
