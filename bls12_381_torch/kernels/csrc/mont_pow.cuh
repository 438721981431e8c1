// Fixed-exponent power in Fp and Fr on Hopper (wrappers and plain version:
// kernels/mont.py `pow_fixed`, `pow_fixed_fr`, `pow_fixed_plain`).
//
//   out[:, b] = a[:, b]^e R^(1-e) mod m (the Montgomery form of a^e),
//   canonical, for a canonical; a and out int32 [2W, B], 16-bit limbs; the
//   field F is fp384::Field (m = p, W = 12) or fr256::Field (m = q, W = 8).
//
// Replaces the JAX package's `limbs.pow_fixed` chain (bls12_381_tpu/
// limbs.py:693: a lax.scan of sqr_pallas and sop_pallas launches, 14 table
// products, then 4 squares and a product per 4-bit digit) with one launch.
// The exponent's digits, most significant first, travel by value in the
// parameter block (a broadcast from the constant cache); the window table
// (one, a, a^2 .. a^15) lives in shared memory; the leading zero digits and
// the products by entry 0 are skipped.  Every value is canonical at the
// store, so the result is the JAX schedule's and pow_fixed_plain's limb
// for limb.  Every inversion (`limbs.inv`) and Fp square root (`fp.sqrt`)
// is one launch of it.
//
// What bounds it.  A lane's chain of dependent steps: at p - 2 ~380
// squares and ~95 products after the leading digit, beside the table's 14.
// At the paths' widths (B <= 1024) the multiplies alone take some 40 times
// less than the chain (chip_smoke.py `pow_work`), and one thread cannot
// issue a 12-word product's ~576 32-bit multiplies in much less than
// ~1,200 cycles; at 2^16 lanes the card's multiply rate bounds it.  The
// design shortens the chain and the instructions per thread:
//
// 1. Carry-flag products (`mont_mul_share`): fp2_pow.cuh's CIOS over 32-bit
//    words, mad.lo.cc / madc.hi.cc chains (carry_chain.cuh), a row's even
//    and odd word products in two accumulators side by side, the
//    reduction's row in the same two, the dropped low words' carry passed
//    into the next row.  At one thread a lane the square is mont_sqr.cuh's
//    (carry_chain.cuh `sqr_words_of`: off-diagonal products in two chains,
//    doubled, the diagonal, the reduction's rows).
// 2. Lazy reduction where the bound allows (F::kLazy).  For Fp, 4p < R: a
//    product of two values below 2p is below 4p^2/R + p < 2p with no
//    subtraction, so the chain's values stay below 2p and one subtraction
//    before the store makes the result canonical.  For Fr, q ~ 0.45 R and
//    4q > R: a value below 2q would not stay below 2q, so every Fr step
//    ends in one conditional subtraction (canonical in, canonical out).
// 3. A lane's product over T threads, neighbours in one warp (the
//    multi-thread CIOS of CGBN, written anew).  Thread k holds words
//    k n .. k n + n - 1 (n = W / T) of the multiplicand and of the
//    modulus, and its share of the accumulator; the multiplier's words
//    come whole to every thread (from the table in shared memory, or the
//    lane's value).  Per row, the row's m comes from the lane's first
//    thread by one __shfl_sync, and each thread's dropped low word goes to
//    the thread below by one __shfl_down_sync, where it is added at word
//    n - 1.  After the last row every thread gathers the n + 1 words of
//    each share (W + T shuffles) and adds them into the lane's value:
//    the same W words on each of its threads, the next square's
//    multiplier.  A thread's chain falls from W rows of W word products to
//    W rows of n, for more instructions a lane (the shuffles, the
//    gather): T is the field's kTpiFp or kTpiFr while the launch leaves
//    schedulers idle, fewer as it fills the card, 1 beyond (`launch_pow`).
// 4. Launch shape: kLanes lanes a block (T kLanes threads), so that the
//    paths' 1024 lanes spread over 1024 / kLanes SMs; the table is 16 x W
//    words a lane, word-major with the lane innermost (a warp's lanes read
//    consecutive words; a lane's threads read the same word, a broadcast),
//    each thread writing its own share of an entry.  The shared-memory cap
//    is raised once per device where the table needs more than 48 KB.
// 5. The ragged tail: threads past B run lane B - 1's chain and skip the
//    store, so every thread of a warp reaches every shuffle and the full
//    mask is right.
//
// Each bound is stated beside the code; tests/test_torch_pow_model.py runs
// the same rows, shares and gathers on Python integers at every T and
// asserts them.  scripts/pow_variants.py times every T and other lanes
// per block (PERF.md).
#pragma once

#include <atomic>

#include "carry_chain.cuh"
#include "montgomery.cuh"

namespace montpow {

using carry::add_words;
using carry::mad_pairs;
using carry::madc_pairs;
using carry::sub_words;
using montgomery::kPowDigits;
using montgomery::PowDigits;
using montgomery::PowIO;

// the library's launch shapes (mont.py POW_TPI, POW_TPI_FR, POW_LANES,
// POW_FILL_THREADS; `launch_pow` picks one by the width)
constexpr int kTpiFp = 4;             // threads per Fp lane, at most
constexpr int kTpiFr = 2;             // threads per Fr lane, at most
constexpr int kLanes = 32;            // lanes per block
constexpr int kFillThreads = 1 << 14;  // a warp for each of the card's 528
                                       // schedulers (132 SMs x 4), rounded

// y = words k n .. k n + n - 1 of the lane's value X (n = W / T): selects,
// since an index by the runtime k would put X in local memory.
template <int W, int T>
__device__ __forceinline__ void take_share(const uint32_t (&X)[W], int k,
                                           uint32_t (&y)[W / T]) {
  constexpr int n = W / T;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    uint32_t v = X[j];
#pragma unroll
    for (int t = 1; t < T; ++t) v = k == t ? X[t * n + j] : v;
    y[j] = v;
  }
}

// X = (x y + M m) R^-1 on the lane's T threads, for x < R, y < R with
// x y < m R (so X < 2m): x whole on every thread, y and mk (the modulus)
// this thread's n = W / T words, k its place in the lane.  X is the same
// W words on every thread of the lane.
//
// CIOS.  A thread's running share is A + B: A holds its row's word
// products x_i y_j for even j (words 0 .. 2 ceil(n/2)), B those for odd j
// (words 0 .. 2 floor(n/2) + 1, word 0 left from the row before), and the
// reduction's m mk_j the same way, m = (A[0] + B[0]) N0 mod 2^32 on the
// lane's first thread, so its A[0] + B[0] = 0 mod 2^32 after the row.
// Then every thread drops its low word: the sum of A[0] and B[0] (0 or
// 2^32 on the first thread) carries 1 into the next row's A[0] where it
// overflows, and its low half goes to the thread below, which adds it at
// word n - 1 (carrying into word n).  Bounds (each row adds below
// 2^(32n+33) to a share, then divides it by 2^32 and adds below 2^(32n)):
// A and B stay below 2^(32n+2), so no chain carries out of its top word
// and a share A + B + carry fits n + 1 words; the top thread's share is
// below 2^(32n), since the lane's value, the shares added at their
// places, is < 2m < R.
template <class F, int T>
__device__ __forceinline__ void mont_mul_share(const uint32_t (&x)[F::W],
                                               const uint32_t (&y)[F::W / T],
                                               const uint32_t (&mk)[F::W / T],
                                               int k, uint32_t (&X)[F::W]) {
  constexpr int W = F::W, n = W / T, NE = (n + 1) / 2, NO = n / 2;
  uint32_t A[2 * NE + 1], B[2 * NO + 2];
#pragma unroll
  for (int j = 0; j < 2 * NE + 1; ++j) A[j] = 0;
#pragma unroll
  for (int j = 0; j < 2 * NO + 2; ++j) B[j] = 0;
  uint32_t cin = 0;  // the dropped words' carry: 1 where cin != 0
#pragma unroll
  for (int i = 0; i < W; ++i) {
    madc_pairs<NE>(A, x[i], y, cin);
    mad_pairs<NO>(B + 1, x[i], y + 1);
    uint32_t m = (A[0] + B[0]) * F::N0;
    if constexpr (T > 1) m = __shfl_sync(0xffffffffu, m, 0, T);
    mad_pairs<NE>(A, m, mk);
    mad_pairs<NO>(B + 1, m, mk + 1);
    uint32_t recv = 0;
    if constexpr (T == 1) {
      cin = B[0];  // A[0] + B[0] = 0 mod 2^32: a carry where B[0] != 0
    } else {
      const uint32_t low = A[0] + B[0];
      cin = low < A[0];
      recv = __shfl_down_sync(0xffffffffu, low, 1, T);
      recv = k == T - 1 ? 0u : recv;  // the top thread's: nothing above
    }
#pragma unroll
    for (int j = 0; j < 2 * NE; ++j) A[j] = A[j + 1];
#pragma unroll
    for (int j = 0; j < 2 * NO + 1; ++j) B[j] = B[j + 1];
    A[2 * NE] = 0, B[2 * NO + 1] = 0;
    if constexpr (T > 1 && n % 2 == 0) {  // at word n - 1, carry to word n
      A[n - 1] += recv;
      A[n] += A[n - 1] < recv;
    } else if constexpr (T > 1) {  // n odd: B's top word is n
      B[n - 1] += recv;
      B[n] += B[n - 1] < recv;
    }
  }
  if constexpr (T == 1) {  // after the last row A + B + carry is X < 2m
    uint32_t b[W];
#pragma unroll
    for (int j = 0; j < W; ++j) X[j] = A[j], b[j] = B[j];
    add_words(X, b, cin);
  } else {
    uint32_t s[n + 1], b[n + 1];
#pragma unroll
    for (int j = 0; j <= n; ++j) s[j] = A[j], b[j] = B[j];
    add_words(s, b, cin);  // this thread's share, < 2^(32n+2)
    // the gather: X = sum_t share_t 2^(32 t n), every thread; share t's
    // word n lands on share t+1's word 0 (the top share's word n is 0)
    uint32_t over[W];
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int j = 0; j < n; ++j)
        X[t * n + j] = __shfl_sync(0xffffffffu, s[j], t, T);
    }
#pragma unroll
    for (int j = 0; j < W; ++j) over[j] = 0;
#pragma unroll
    for (int t = 0; t + 1 < T; ++t)
      over[(t + 1) * n] = __shfl_sync(0xffffffffu, s[n], t, T);
    add_words(X, over);  // X < 2m < R: no carry out
  }
}

// X = X - m where X >= m: X < 2m in, canonical out (the same on every
// thread of the lane).
template <class F>
__device__ __forceinline__ void reduce_once(uint32_t (&X)[F::W]) {
  constexpr int W = F::W;
  uint32_t c[W], m[W];
#pragma unroll
  for (int j = 0; j < W; ++j) c[j] = X[j], m[j] = F::word(j);
  const uint32_t below = sub_words(c, m);
#pragma unroll
  for (int j = 0; j < W; ++j) X[j] = below ? X[j] : c[j];
}

// One step of the chain: X = x X R^-1 (x = X for a square), below 2m for
// Fp, canonical for Fr.  Fp: x, X < 2m in (4m^2 < mR); Fr: x, X < m in
// (m^2 < mR), then one subtraction.
template <class F, int T, bool kSquare>
__device__ __forceinline__ void pow_step(const uint32_t (&x)[F::W],
                                         const uint32_t (&mk)[F::W / T],
                                         int k, uint32_t (&X)[F::W]) {
  if constexpr (kSquare && T == 1) {
    carry::sqr_words_of<F, !F::kLazy>(X, X);
  } else {
    uint32_t y[F::W / T];
    take_share<F::W, T>(X, k, y);
    mont_mul_share<F, T>(x, y, mk, k, X);
    if constexpr (!F::kLazy) reduce_once<F>(X);
  }
}

template <class F, int T, int kL>
__global__ void __launch_bounds__(T * kL)
mont_pow_kernel(const PowIO io, int n_digits, int B,
                const __grid_constant__ PowDigits e) {
  constexpr int W = F::W, n = W / T;
  constexpr int entry = W * kL;        // words from one entry to the next
  extern __shared__ uint32_t table[];  // [16][W][kL]
  const int x = threadIdx.x / T;       // the lane in the block
  const int k = threadIdx.x % T;       // its words: k n .. k n + n - 1
  const int lane = blockIdx.x * kL + x;
  const bool live = lane < B;
  const int src = live ? lane : B - 1;  // threads past B run lane B - 1
  uint32_t* col = table + x;
  uint32_t* mine = col + k * n * kL;    // this thread's words of entry 0
  uint32_t mk[n];                       // this thread's words of m
#pragma unroll
  for (int j = 0; j < n; ++j) {
    if constexpr (T == 1) mk[j] = F::word(j);   // immediates
    else mk[j] = F::p(k * n + j);               // the constant bank, once
  }
  uint32_t a[W], X[W], y[n];
  montgomery::load16(io.a[0] + src, B, a);  // canonical: < m
#pragma unroll
  for (int j = 0; j < W; ++j) X[j] = F::one(j);  // entry 0: one
  take_share<W, T>(X, k, y);
  montgomery::store32(mine, kL, y);
  take_share<W, T>(a, k, y);                     // entry 1: a
  montgomery::store32(mine + entry, kL, y);
#pragma unroll
  for (int j = 0; j < W; ++j) X[j] = a[j];
#pragma unroll 1
  for (int d = 2; d < 16; ++d) {  // entry d = a^d: < 2m (Fp), < m (Fr)
    pow_step<F, T, false>(a, mk, k, X);
    take_share<W, T>(X, k, y);
    montgomery::store32(mine + d * entry, kL, y);
  }
  __syncwarp();  // a lane's entries are read whole below
  int i = 0;
  while (i < n_digits && e.d[i] == 0) ++i;
  const int first = i < n_digits ? e.d[i] : 0;
  montgomery::load32(col + first * entry, kL, X);
#pragma unroll 1
  for (++i; i < n_digits; ++i) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) pow_step<F, T, true>(X, mk, k, X);
    const int d = e.d[i];  // the same on every thread: no divergence
    if (d != 0) {
      uint32_t t[W];
      montgomery::load32(col + d * entry, kL, t);
      pow_step<F, T, false>(t, mk, k, X);
    }
  }
  if constexpr (F::kLazy) reduce_once<F>(X);  // canonical: X < 2m
  take_share<W, T>(X, k, y);
  if (live)
    montgomery::store16(io.out[0] + (size_t)(2 * k * n) * B + lane, B, y);
}

// Launch mont_pow_kernel<F, T, kL> on `stream`: out = a^e over int32
// [2W, B] limbs; digits: n_digits host bytes, each < 16, most significant
// first.  A table above 48 KB a block raises the cap once per device of
// the process (an attribute of the kernel on the current device).  Returns
// cudaGetLastError() (or the error of raising the cap), or
// cudaErrorInvalidValue for a width, count or digit the kernel does not
// take.  static, not inline: the flag is then this library's own (an
// inline function's static is one object across every library of the
// process that holds this header).
template <class F, int T, int kL>
static int launch_pow_shape(const void* a, void* out, const uint8_t* digits,
                            int n_digits, int B, void* stream) {
  static_assert(F::W % T == 0 && 32 % T == 0, "T threads share a lane");
  constexpr int smem = 16 * F::W * (int)sizeof(uint32_t) * kL;
  static std::atomic<unsigned long long> raised{0};  // bit d: device d
  if (B < 1 || n_digits < 0 || n_digits > kPowDigits)
    return (int)cudaErrorInvalidValue;
  PowDigits e = {};
  for (int i = 0; i < n_digits; ++i) {
    if (digits[i] > 15) return (int)cudaErrorInvalidValue;
    e.d[i] = digits[i];
  }
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
    if (!bit || !(raised.load() & bit)) {
      err = cudaFuncSetAttribute(mont_pow_kernel<F, T, kL>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return (int)err;
      raised.fetch_or(bit);
    }
  }
  PowIO io = {};
  io.a[0] = (const int32_t*)a, io.out[0] = (int32_t*)out;
  const int grid = (B + kL - 1) / kL;
  mont_pow_kernel<F, T, kL><<<grid, T * kL, smem, (cudaStream_t)stream>>>(
      io, n_digits, B, e);
  return (int)cudaGetLastError();
}

// The library's shape by the width: the field's threads per lane (kTpiFp
// or kTpiFr), halved until the launch's threads fit kFillThreads, one
// thread a lane beyond that.  More threads a lane shorten a lane's chain
// while the card's schedulers would otherwise idle; once every scheduler
// holds a warp they only add instructions (each row's shuffles, the
// gather), and one thread a lane, the fewest instructions, is fastest.
// At p - 2 (H100, scripts/pow_variants.py; PERF.md): Fp 4 threads up to
// 4096 lanes, 2 at 8192, 1 from 16384; Fr 2 up to 8192, 1 from 16384.
template <class F>
static int launch_pow(const void* a, void* out, const uint8_t* digits,
                      int n_digits, int B, void* stream) {
  constexpr int T = F::W == 12 ? kTpiFp : kTpiFr;
  if constexpr (T >= 4) {
    if ((long long)B * 4 <= kFillThreads)
      return launch_pow_shape<F, 4, kLanes>(a, out, digits, n_digits, B,
                                            stream);
  }
  if constexpr (T >= 2) {
    if ((long long)B * 2 <= kFillThreads)
      return launch_pow_shape<F, 2, kLanes>(a, out, digits, n_digits, B,
                                            stream);
  }
  return launch_pow_shape<F, 1, kLanes>(a, out, digits, n_digits, B, stream);
}

}  // namespace montpow
