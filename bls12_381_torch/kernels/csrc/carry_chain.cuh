// Carry-chain word arithmetic on Hopper, shared by the Fp2 power
// (fp2_pow.cuh), the Montgomery square (mont_sqr.cuh) and the Fp and Fr
// power (mont_pow.cuh).
//
// An element is N little-endian 32-bit words (12 for Fp, 8 for Fr; a
// thread's share of one in mont_pow.cuh holds fewer).  The additions ride
// the hardware carry flag (PTX add.cc / addc, mad.lo.cc / madc.hi.cc), the
// approach of Supranational's sppark `mont_t`, written anew.  The flag does
// not survive from one asm statement to the next, so each chain is one
// statement, one per word count (the counts the kernels use); where a chain
// carries on, the carry goes out and comes back in a register (`cin`,
// `cout`).  The statements are not volatile, so ptxas may schedule around
// them.  The word count and the modulus come from the field (fp384.cuh,
// fr256.cuh); W, kN0 and p_word below are the Fp field's, for the Fp2
// power and the square.
#pragma once

#include <cstdint>

#include "fp384.cuh"

namespace carry {

constexpr int W = fp384::Field::W;       // 32-bit words of an Fp element
constexpr uint32_t kN0 = fp384::Field::N0;  // -p^-1 mod 2^32

// Word j of p and of 2p (fp384.cuh's kP), as immediates.
__device__ __forceinline__ uint32_t p_word(int j) {
  return fp384::Field::word(j);
}

__device__ __forceinline__ uint32_t two_p_word(int j) {
  constexpr uint32_t w[W] = {
      0xffff5556u, 0x73fdffffu, 0x62a7ffffu, 0x3d57fffdu,
      0xed61ec48u, 0xce61a541u, 0xe70a257eu, 0xc8ee9709u,
      0x869759aeu, 0x96374f6cu, 0x72ffcd34u, 0x340223d4u};
  return w[j];
}

// acc[0..2N] += x (y[0] + y[2] 2^64 + ... + y[2N-2] 2^(64(N-1))), N <= 6:
// y points at N words two apart (the even or the odd words of an element).
// The halves of the N word products fill disjoint word pairs, so one carry
// chain adds them all, ending in acc[2N]; the callers' bounds keep acc[2N]
// from carrying out.
template <int N>
__device__ __forceinline__ void mad_pairs(uint32_t* acc, uint32_t x,
                                          const uint32_t* y) {
  static_assert(1 <= N && N <= 6, "mad_pairs: 1 to 6 word products");
  if constexpr (N == 1) {
    asm("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
        "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
        "addc.u32 %2, %2, 0;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2])
        : "r"(x), "r"(y[0]));
  } else if constexpr (N == 2) {
    asm("mad.lo.cc.u32 %0, %5, %6, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %6, %1;\n\t"
        "madc.lo.cc.u32 %2, %5, %7, %2;\n\t"
        "madc.hi.cc.u32 %3, %5, %7, %3;\n\t"
        "addc.u32 %4, %4, 0;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4])
        : "r"(x), "r"(y[0]), "r"(y[2]));
  } else if constexpr (N == 3) {
    asm("mad.lo.cc.u32 %0, %7, %8, %0;\n\t"
        "madc.hi.cc.u32 %1, %7, %8, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %9, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %9, %3;\n\t"
        "madc.lo.cc.u32 %4, %7, %10, %4;\n\t"
        "madc.hi.cc.u32 %5, %7, %10, %5;\n\t"
        "addc.u32 %6, %6, 0;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
          "+r"(acc[5]), "+r"(acc[6])
        : "r"(x), "r"(y[0]), "r"(y[2]), "r"(y[4]));
  } else if constexpr (N == 4) {
    asm("mad.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
          "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(acc[8])
        : "r"(x), "r"(y[0]), "r"(y[2]), "r"(y[4]), "r"(y[6]));
  } else if constexpr (N == 5) {
    asm("mad.lo.cc.u32 %0, %11, %12, %0;\n\t"
        "madc.hi.cc.u32 %1, %11, %12, %1;\n\t"
        "madc.lo.cc.u32 %2, %11, %13, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %11, %14, %4;\n\t"
        "madc.hi.cc.u32 %5, %11, %14, %5;\n\t"
        "madc.lo.cc.u32 %6, %11, %15, %6;\n\t"
        "madc.hi.cc.u32 %7, %11, %15, %7;\n\t"
        "madc.lo.cc.u32 %8, %11, %16, %8;\n\t"
        "madc.hi.cc.u32 %9, %11, %16, %9;\n\t"
        "addc.u32 %10, %10, 0;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
          "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(acc[8]), "+r"(acc[9]),
          "+r"(acc[10])
        : "r"(x), "r"(y[0]), "r"(y[2]), "r"(y[4]), "r"(y[6]), "r"(y[8]));
  } else if constexpr (N == 6) {
    asm("mad.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
          "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(acc[8]), "+r"(acc[9]),
          "+r"(acc[10]), "+r"(acc[11]), "+r"(acc[12])
        : "r"(x), "r"(y[0]), "r"(y[2]), "r"(y[4]), "r"(y[6]), "r"(y[8]),
          "r"(y[10]));
  }
}

// mad_pairs with one more carry into acc[0]: 1 where cin != 0.
template <int N>
__device__ __forceinline__ void madc_pairs(uint32_t* acc, uint32_t x,
                                           const uint32_t* y, uint32_t cin) {
  static_assert(N == 1 || N == 2 || N == 3 || N == 4 || N == 6,
                "madc_pairs: 1, 2, 3, 4 or 6 word products");
  if constexpr (N == 1) {
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %5, 0xffffffff;\n\t"
        "madc.lo.cc.u32 %0, %3, %4, %0;\n\t"
        "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
        "addc.u32 %2, %2, 0;\n\t}"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2])
        : "r"(x), "r"(y[0]), "r"(cin));
  } else if constexpr (N == 2) {
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %8, 0xffffffff;\n\t"
        "madc.lo.cc.u32 %0, %5, %6, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %6, %1;\n\t"
        "madc.lo.cc.u32 %2, %5, %7, %2;\n\t"
        "madc.hi.cc.u32 %3, %5, %7, %3;\n\t"
        "addc.u32 %4, %4, 0;\n\t}"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4])
        : "r"(x), "r"(y[0]), "r"(y[2]), "r"(cin));
  } else if constexpr (N == 3) {
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %11, 0xffffffff;\n\t"
        "madc.lo.cc.u32 %0, %7, %8, %0;\n\t"
        "madc.hi.cc.u32 %1, %7, %8, %1;\n\t"
        "madc.lo.cc.u32 %2, %7, %9, %2;\n\t"
        "madc.hi.cc.u32 %3, %7, %9, %3;\n\t"
        "madc.lo.cc.u32 %4, %7, %10, %4;\n\t"
        "madc.hi.cc.u32 %5, %7, %10, %5;\n\t"
        "addc.u32 %6, %6, 0;\n\t}"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
          "+r"(acc[5]), "+r"(acc[6])
        : "r"(x), "r"(y[0]), "r"(y[2]), "r"(y[4]), "r"(cin));
  } else if constexpr (N == 4) {
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %14, 0xffffffff;\n\t"
        "madc.lo.cc.u32 %0, %9, %10, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
        "madc.lo.cc.u32 %4, %9, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %9, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %9, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %9, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t}"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
          "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(acc[8])
        : "r"(x), "r"(y[0]), "r"(y[2]), "r"(y[4]), "r"(y[6]), "r"(cin));
  } else if constexpr (N == 6) {
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %20, 0xffffffff;\n\t"
        "madc.lo.cc.u32 %0, %13, %14, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, %13, %15, %2;\n\t"
        "madc.hi.cc.u32 %3, %13, %15, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %16, %5;\n\t"
        "madc.lo.cc.u32 %6, %13, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %13, %17, %7;\n\t"
        "madc.lo.cc.u32 %8, %13, %18, %8;\n\t"
        "madc.hi.cc.u32 %9, %13, %18, %9;\n\t"
        "madc.lo.cc.u32 %10, %13, %19, %10;\n\t"
        "madc.hi.cc.u32 %11, %13, %19, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t}"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
          "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(acc[8]), "+r"(acc[9]),
          "+r"(acc[10]), "+r"(acc[11]), "+r"(acc[12])
        : "r"(x), "r"(y[0]), "r"(y[2]), "r"(y[4]), "r"(y[6]), "r"(y[8]),
          "r"(y[10]), "r"(cin));
  }
}

// mad_pairs over six words: acc[0..12] += x (y[0] + y[2] 2^64 + ... +
// y[10] 2^320), the even or the odd words of an Fp element.
__device__ __forceinline__ void mad_row(uint32_t* acc, uint32_t x,
                                        const uint32_t* y) {
  mad_pairs<6>(acc, x, y);
}

// mad_row with one more carry into acc[0]: 1 where cin != 0.
__device__ __forceinline__ void madc_row(uint32_t* acc, uint32_t x,
                                         const uint32_t* y, uint32_t cin) {
  madc_pairs<6>(acc, x, y, cin);
}

// r += b + (1 where cin != 0) over N words, the carry out dropped (the
// callers' sums are < 2^(32 N)).
template <int N>
__device__ __forceinline__ void add_words(uint32_t (&r)[N],
                                          const uint32_t (&b)[N],
                                          uint32_t cin = 0) {
  static_assert(N == 3 || N == 4 || N == 5 || N == 7 || N == 8 || N == 12,
                "add_words: 3, 4, 5, 7, 8 or 12 words");
  if constexpr (N == 3) {
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %6, 0xffffffff;\n\t"
        "addc.cc.u32 %0, %0, %3;\n\t"
        "addc.cc.u32 %1, %1, %4;\n\t"
        "addc.u32 %2, %2, %5;\n\t}"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2])
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(cin));
  } else if constexpr (N == 4) {
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %8, 0xffffffff;\n\t"
        "addc.cc.u32 %0, %0, %4;\n\t"
        "addc.cc.u32 %1, %1, %5;\n\t"
        "addc.cc.u32 %2, %2, %6;\n\t"
        "addc.u32 %3, %3, %7;\n\t}"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3])
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(cin));
  } else if constexpr (N == 5) {
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %10, 0xffffffff;\n\t"
        "addc.cc.u32 %0, %0, %5;\n\t"
        "addc.cc.u32 %1, %1, %6;\n\t"
        "addc.cc.u32 %2, %2, %7;\n\t"
        "addc.cc.u32 %3, %3, %8;\n\t"
        "addc.u32 %4, %4, %9;\n\t}"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4])
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(cin));
  } else if constexpr (N == 7) {
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %14, 0xffffffff;\n\t"
        "addc.cc.u32 %0, %0, %7;\n\t"
        "addc.cc.u32 %1, %1, %8;\n\t"
        "addc.cc.u32 %2, %2, %9;\n\t"
        "addc.cc.u32 %3, %3, %10;\n\t"
        "addc.cc.u32 %4, %4, %11;\n\t"
        "addc.cc.u32 %5, %5, %12;\n\t"
        "addc.u32 %6, %6, %13;\n\t}"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
          "+r"(r[5]), "+r"(r[6])
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
          "r"(b[6]), "r"(cin));
  } else if constexpr (N == 8) {
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %16, 0xffffffff;\n\t"
        "addc.cc.u32 %0, %0, %8;\n\t"
        "addc.cc.u32 %1, %1, %9;\n\t"
        "addc.cc.u32 %2, %2, %10;\n\t"
        "addc.cc.u32 %3, %3, %11;\n\t"
        "addc.cc.u32 %4, %4, %12;\n\t"
        "addc.cc.u32 %5, %5, %13;\n\t"
        "addc.cc.u32 %6, %6, %14;\n\t"
        "addc.u32 %7, %7, %15;\n\t}"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
          "+r"(r[5]), "+r"(r[6]), "+r"(r[7])
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
          "r"(b[6]), "r"(b[7]), "r"(cin));
  } else if constexpr (N == 12) {
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %24, 0xffffffff;\n\t"
        "addc.cc.u32 %0, %0, %12;\n\t"
        "addc.cc.u32 %1, %1, %13;\n\t"
        "addc.cc.u32 %2, %2, %14;\n\t"
        "addc.cc.u32 %3, %3, %15;\n\t"
        "addc.cc.u32 %4, %4, %16;\n\t"
        "addc.cc.u32 %5, %5, %17;\n\t"
        "addc.cc.u32 %6, %6, %18;\n\t"
        "addc.cc.u32 %7, %7, %19;\n\t"
        "addc.cc.u32 %8, %8, %20;\n\t"
        "addc.cc.u32 %9, %9, %21;\n\t"
        "addc.cc.u32 %10, %10, %22;\n\t"
        "addc.u32 %11, %11, %23;\n\t}"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
          "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "+r"(r[8]), "+r"(r[9]),
          "+r"(r[10]), "+r"(r[11])
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
          "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]),
          "r"(cin));
  }
}

// r -= b over N words; returns 0xffffffff on a borrow out (r < b), else 0.
template <int N>
__device__ __forceinline__ uint32_t sub_words(uint32_t (&r)[N],
                                              const uint32_t (&b)[N]) {
  static_assert(N == 8 || N == 12, "sub_words: 8 or 12 words");
  uint32_t mask;
  if constexpr (N == 8) {
    asm("sub.cc.u32 %0, %0, %9;\n\t"
        "subc.cc.u32 %1, %1, %10;\n\t"
        "subc.cc.u32 %2, %2, %11;\n\t"
        "subc.cc.u32 %3, %3, %12;\n\t"
        "subc.cc.u32 %4, %4, %13;\n\t"
        "subc.cc.u32 %5, %5, %14;\n\t"
        "subc.cc.u32 %6, %6, %15;\n\t"
        "subc.cc.u32 %7, %7, %16;\n\t"
        "subc.u32 %8, 0, 0;"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
          "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "=r"(mask)
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
          "r"(b[6]), "r"(b[7]));
  } else if constexpr (N == 12) {
    asm("sub.cc.u32 %0, %0, %13;\n\t"
        "subc.cc.u32 %1, %1, %14;\n\t"
        "subc.cc.u32 %2, %2, %15;\n\t"
        "subc.cc.u32 %3, %3, %16;\n\t"
        "subc.cc.u32 %4, %4, %17;\n\t"
        "subc.cc.u32 %5, %5, %18;\n\t"
        "subc.cc.u32 %6, %6, %19;\n\t"
        "subc.cc.u32 %7, %7, %20;\n\t"
        "subc.cc.u32 %8, %8, %21;\n\t"
        "subc.cc.u32 %9, %9, %22;\n\t"
        "subc.cc.u32 %10, %10, %23;\n\t"
        "subc.cc.u32 %11, %11, %24;\n\t"
        "subc.u32 %12, 0, 0;"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
          "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "+r"(r[8]), "+r"(r[9]),
          "+r"(r[10]), "+r"(r[11]), "=r"(mask)
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
          "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
  }
  return mask;
}

// r[0..N-1] += b[0..N-1] + (1 where cin != 0); returns the carry out of
// r[N-1], 0 or 1 (add_words with the carry kept: a chain longer than N
// words goes as two statements, the carry passed in a register between
// them).
template <int N = W>
__device__ __forceinline__ uint32_t add_words_carry(uint32_t* r,
                                                    const uint32_t* b,
                                                    uint32_t cin) {
  static_assert(N == 8 || N == 12, "add_words_carry: 8 or 12 words");
  uint32_t cout;
  if constexpr (N == 8) {
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %17, 0xffffffff;\n\t"
        "addc.cc.u32 %0, %0, %9;\n\t"
        "addc.cc.u32 %1, %1, %10;\n\t"
        "addc.cc.u32 %2, %2, %11;\n\t"
        "addc.cc.u32 %3, %3, %12;\n\t"
        "addc.cc.u32 %4, %4, %13;\n\t"
        "addc.cc.u32 %5, %5, %14;\n\t"
        "addc.cc.u32 %6, %6, %15;\n\t"
        "addc.cc.u32 %7, %7, %16;\n\t"
        "addc.u32 %8, 0, 0;\n\t}"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
          "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "=r"(cout)
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
          "r"(b[6]), "r"(b[7]), "r"(cin));
  } else if constexpr (N == 12) {
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %25, 0xffffffff;\n\t"
        "addc.cc.u32 %0, %0, %13;\n\t"
        "addc.cc.u32 %1, %1, %14;\n\t"
        "addc.cc.u32 %2, %2, %15;\n\t"
        "addc.cc.u32 %3, %3, %16;\n\t"
        "addc.cc.u32 %4, %4, %17;\n\t"
        "addc.cc.u32 %5, %5, %18;\n\t"
        "addc.cc.u32 %6, %6, %19;\n\t"
        "addc.cc.u32 %7, %7, %20;\n\t"
        "addc.cc.u32 %8, %8, %21;\n\t"
        "addc.cc.u32 %9, %9, %22;\n\t"
        "addc.cc.u32 %10, %10, %23;\n\t"
        "addc.cc.u32 %11, %11, %24;\n\t"
        "addc.u32 %12, 0, 0;\n\t}"
        : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3]), "+r"(r[4]),
          "+r"(r[5]), "+r"(r[6]), "+r"(r[7]), "+r"(r[8]), "+r"(r[9]),
          "+r"(r[10]), "+r"(r[11]), "=r"(cout)
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
          "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]),
          "r"(cin));
  }
  return cout;
}

// acc[0..2N-1] += a[0]^2 + a[1]^2 2^64 + ... + a[N-1]^2 2^(64(N-1)) + (1
// where cin != 0): N diagonal squares of a product, one carry chain;
// returns the carry out of acc[2N-1], 0 or 1.
template <int N = W / 2>
__device__ __forceinline__ uint32_t mad_squares(uint32_t* acc,
                                                const uint32_t* a,
                                                uint32_t cin) {
  static_assert(N == 4 || N == 6, "mad_squares: 4 or 6 squares");
  uint32_t cout;
  if constexpr (N == 4) {
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %13, 0xffffffff;\n\t"
        "madc.lo.cc.u32 %0, %9, %9, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %9, %1;\n\t"
        "madc.lo.cc.u32 %2, %10, %10, %2;\n\t"
        "madc.hi.cc.u32 %3, %10, %10, %3;\n\t"
        "madc.lo.cc.u32 %4, %11, %11, %4;\n\t"
        "madc.hi.cc.u32 %5, %11, %11, %5;\n\t"
        "madc.lo.cc.u32 %6, %12, %12, %6;\n\t"
        "madc.hi.cc.u32 %7, %12, %12, %7;\n\t"
        "addc.u32 %8, 0, 0;\n\t}"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
          "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "=r"(cout)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(cin));
  } else if constexpr (N == 6) {
    asm("{\n\t.reg .u32 t;\n\t"
        "add.cc.u32 t, %19, 0xffffffff;\n\t"
        "madc.lo.cc.u32 %0, %13, %13, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %14, %14, %2;\n\t"
        "madc.hi.cc.u32 %3, %14, %14, %3;\n\t"
        "madc.lo.cc.u32 %4, %15, %15, %4;\n\t"
        "madc.hi.cc.u32 %5, %15, %15, %5;\n\t"
        "madc.lo.cc.u32 %6, %16, %16, %6;\n\t"
        "madc.hi.cc.u32 %7, %16, %16, %7;\n\t"
        "madc.lo.cc.u32 %8, %17, %17, %8;\n\t"
        "madc.hi.cc.u32 %9, %17, %17, %9;\n\t"
        "madc.lo.cc.u32 %10, %18, %18, %10;\n\t"
        "madc.hi.cc.u32 %11, %18, %18, %11;\n\t"
        "addc.u32 %12, 0, 0;\n\t}"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
          "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(acc[8]), "+r"(acc[9]),
          "+r"(acc[10]), "+r"(acc[11]), "=r"(cout)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
          "r"(cin));
  }
  return cout;
}

// Off-diagonal row I and the rows after it, over N words: A += a_I
// (a_(I+1) 2^(32(2I+1)) + a_(I+3) 2^(32(2I+3)) + ...), B += a_I (a_(I+2)
// 2^(32(2I+2)) + ...).  After row I, A and B are each below (sum_{r<=I}
// a_r 2^(32r)) 2^(32N) < 2^(32(I+N+1)), and each chain ends at column
// I + N or above, so no chain carries out of its last word.
template <int N, int I>
__device__ __forceinline__ void off_diagonal(uint32_t (&A)[2 * N],
                                             uint32_t (&B)[2 * N],
                                             const uint32_t (&a)[N]) {
  mad_pairs<(N - I) / 2>(A + 2 * I + 1, a[I], a + I + 1);
  if constexpr ((N - 1 - I) / 2 > 0)
    mad_pairs<(N - 1 - I) / 2>(B + 2 * I + 2, a[I], a + I + 2);
  if constexpr (I + 2 < N) off_diagonal<N, I + 1>(A, B, a);
}

// r = (a^2 + M m) R^-1 for the field F (F::W words, modulus m, R =
// 2^(32 W)), for a < R: below m + a^2 / R.  kReduce: then one conditional
// subtraction, canonical for a^2 < m R (a < m).  Without it the result
// is below 2m for a < 2m where 4m < R (Fp: mont_pow.cuh's lazy square).
template <class F, bool kReduce>
__device__ __forceinline__ void sqr_words_of(const uint32_t (&a)[F::W],
                                             uint32_t (&r)[F::W]) {
  constexpr int N = F::W;
  // 1. A + B = sum_{i<j} a_i a_j 2^(32(i+j)) < a^2 / 2 < 2^(64N - 1)
  uint32_t A[2 * N], B[2 * N];
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) A[k] = 0, B[k] = 0;
  off_diagonal<N, 0>(A, B, a);
  // 2. t = 2 (A + B) + sum_i a_i^2 2^(64 i) = a^2 < 2^(64N): neither
  // second chain carries out
  add_words_carry<N>(A + N, B + N, add_words_carry<N>(A, B, 0));
  uint32_t t[2 * N];
#pragma unroll
  for (int k = 2 * N - 1; k > 0; --k)
    t[k] = __funnelshift_l(A[k - 1], A[k], 1);
  t[0] = A[0] << 1;
  mad_squares<N / 2>(t + N, a + N / 2, mad_squares<N / 2>(t, a, 0));
  // 3. reduce the low half: rows as fp2_pow.cuh's mont_sum, without its
  // products.  In a row the running value x + y < 2^(32N+1) + 2^(32N+33)
  // (x[N] <= 1, y[N + 1] <= 1); after the last, x + y + carry =
  // (t mod R + M m) / R <= m
  uint32_t p[N], x[N + 1], y[N + 2];
#pragma unroll
  for (int j = 0; j < N; ++j) p[j] = F::word(j), x[j] = t[j];
  x[N] = 0;
#pragma unroll
  for (int j = 0; j < N + 2; ++j) y[j] = 0;
  uint32_t cin = 0;  // the dropped words' carry: 1 where cin != 0
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t m = (x[0] + y[0] + (cin != 0)) * F::N0;
    madc_pairs<N / 2>(x, m, p, cin);
    mad_pairs<N / 2>(y + 1, m, p + 1);
    cin = y[0];  // x[0] + y[0] = 0 mod 2^32
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = x[j + 1];
#pragma unroll
    for (int j = 0; j <= N; ++j) y[j] = y[j + 1];
    x[N] = 0, y[N + 1] = 0;
  }
  // s = x + y + carry + t / R <= m + a^2 / R: below 2m for a < m, and for
  // a < 2m where 4m < R
  uint32_t s[N], v[N], h[N];
#pragma unroll
  for (int j = 0; j < N; ++j) s[j] = x[j], v[j] = y[j], h[j] = t[N + j];
  add_words(s, v, cin);
  add_words(s, h);
  if constexpr (kReduce) {  // one subtraction: canonical
    uint32_t c[N];
#pragma unroll
    for (int j = 0; j < N; ++j) c[j] = s[j];
    const uint32_t below = sub_words(c, p);
#pragma unroll
    for (int j = 0; j < N; ++j) r[j] = below ? s[j] : c[j];
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) r[j] = s[j];
  }
}

}  // namespace carry
