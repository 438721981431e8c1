// Carry-chain word arithmetic for the 384-bit field on Hopper, shared by
// the Fp2 power (fp2_pow.cuh) and the Montgomery square (mont_sqr.cuh).
//
// An Fp element is W = 12 little-endian 32-bit words.  The additions ride
// the hardware carry flag (PTX add.cc / addc, mad.lo.cc / madc.hi.cc), the
// approach of Supranational's sppark `mont_t`, written anew.  The flag does
// not survive from one asm statement to the next, so each chain is one
// statement; where a chain carries on, the carry goes out and comes back in
// a register (`cin`, `cout`).  The statements are not volatile, so ptxas
// may schedule around them.
#pragma once

#include <cstdint>

namespace carry {

constexpr int W = 12;                  // 32-bit words of an Fp element
constexpr uint32_t kN0 = 0xfffcfffdu;  // -p^-1 mod 2^32

// Word j of p and of 2p (fp384.cuh's kP), as immediates.
__device__ __forceinline__ uint32_t p_word(int j) {
  constexpr uint32_t w[W] = {
      0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
      0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
      0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
  return w[j];
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

// mad_pairs over six words: acc[0..12] += x (y[0] + y[2] 2^64 + ... +
// y[10] 2^320), the even or the odd words of an element.
__device__ __forceinline__ void mad_row(uint32_t* acc, uint32_t x,
                                        const uint32_t* y) {
  mad_pairs<6>(acc, x, y);
}

// mad_row with one more carry into acc[0]: 1 where cin != 0.
__device__ __forceinline__ void madc_row(uint32_t* acc, uint32_t x,
                                         const uint32_t* y, uint32_t cin) {
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
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
        "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]),
        "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]),
        "+r"(acc[12])
      : "r"(x), "r"(y[0]), "r"(y[2]), "r"(y[4]), "r"(y[6]), "r"(y[8]),
        "r"(y[10]), "r"(cin));
}

// r += b + (1 where cin != 0) over 12 words, the carry out dropped (the
// callers' sums are < 2^384).
__device__ __forceinline__ void add_words(uint32_t (&r)[W],
                                          const uint32_t (&b)[W],
                                          uint32_t cin = 0) {
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

// r -= b over 12 words; returns 0xffffffff on a borrow out (r < b), else 0.
__device__ __forceinline__ uint32_t sub_words(uint32_t (&r)[W],
                                              const uint32_t (&b)[W]) {
  uint32_t mask;
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
        "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]),
        "r"(b[11]));
  return mask;
}

// r[0..11] += b[0..11] + (1 where cin != 0); returns the carry out of r[11],
// 0 or 1 (add_words with the carry kept: a chain longer than 12 words goes
// as two statements, the carry passed in a register between them).
__device__ __forceinline__ uint32_t add_words_carry(uint32_t* r,
                                                    const uint32_t* b,
                                                    uint32_t cin) {
  uint32_t cout;
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
  return cout;
}

// acc[0..11] += a[0]^2 + a[1]^2 2^64 + ... + a[5]^2 2^320 + (1 where
// cin != 0): six diagonal squares of a product, one carry chain; returns
// the carry out of acc[11], 0 or 1.
__device__ __forceinline__ uint32_t mad_squares(uint32_t* acc,
                                                const uint32_t* a,
                                                uint32_t cin) {
  uint32_t cout;
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
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
        "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]),
        "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]),
        "=r"(cout)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(cin));
  return cout;
}

}  // namespace carry
