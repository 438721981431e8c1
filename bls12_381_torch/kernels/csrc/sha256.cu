// Batched SHA-256 and expand_message_xmd over SHA-256 (draft-16 §5.3.1),
// one thread per message (wrappers and notes: kernels/sha256.py).
//
//   bls_sha256: out[b] = SHA-256(msg[b]), msg uint8 [B, msg_len] (msg_len
//               may be 0), out uint8 [B, 32]
//   bls_expand_xmd_sha256: out[b] = expand_message_xmd(msg[b], DST,
//               len_in_bytes), msg uint8 [B, msg_len], out uint8
//               [B, len_in_bytes]; everything that is the same for every
//               lane comes from the host in one XmdParams (an oversize DST
//               is reduced there first)
//
// Replaces bls12_381_tpu/kernels/sha256_jax.py:96 `sha256` and :113
// `expand_message_xmd_sha256`, which are jnp (XLA fuses them inside the
// jitted hash-to-curve graph), not Pallas kernels.
//
// What bounds them on this card.  A lane's work is a serial chain: every
// compression depends on the state the previous one left, and every
// b_i on b_(i-1).  A 32-byte message expanded to 256 bytes under a
// 10-byte DST is 9 compressions (b0 after the Z_pad midstate, b1..b8), each
// 64 rounds of at least 14 32-bit instructions (a LOP3 for ch, maj and
// each three-way xor, an IADD3 for each add of three, a funnel shift for
// each rotation) and 48 schedule words of 10: ~1400 a compression.  At
// hash to curve's 256 lanes that is 2 blocks on 2 of the 132 SMs, one warp
// per scheduler: neither the operations (~0.2 us of the card's 32-bit
// rate) nor the bytes (~0.02 us) come near the time, which is one
// thread's chain of instructions, issued one a cycle.  At 2^16 lanes the
// card is full and the operation rate is the bound.
//
// The digest kernel keeps the first design: the state and a 16-word ring of
// the message schedule in registers, the round constants in __constant__
// memory (every thread at the same round reads a broadcast), rotations by
// single funnel shifts, each block's words assembled from bytes.
//
// The XMD kernel spends its instructions on rounds.  Its first version
// assembled each of a block's 16 words from 4 bytes through a
// select chain on runtime positions (message, 0x80, length, DST' read a
// byte at a time from the parameter block), and stored its output a byte
// at a time, 32 lanes of a warp store len_in_bytes apart: most of a
// compression's instructions were assembly, and at 256 lanes the stores
// took about as long as the chain.  So:
// 1. What is the same for every lane comes from the host as big-endian
//    words (`xmd_params`): the state after Z_pad, b0's input after the
//    message (I2OSP(len_in_bytes, 2) || 0 || DST' || padding) laid out
//    from the message's last whole word, and b_i's input after its first
//    32 bytes (I2OSP(i, 1) || DST' || padding) with the byte of i zero, OR-ed
//    in as i << 24.  A block's words are then message words or parameter
//    words, read at a uniform index; only where msg_len % 4 != 0 is one
//    word both, and only that word is assembled from bytes.
// 2. Word-wide I/O: the message row is read as 16-byte or 4-byte loads
//    where its address and msg_len allow (the wrapper picks the instance,
//    kLoad = 16, 4 or 1; every instance is held to the plain version), and
//    each b_i is written as big-endian words (__byte_perm), as 16-byte
//    stores where the row is aligned; the ragged last b_i writes exactly
//    its bytes.
// 3. A shorter round: h + K[t] + W[t] is summed one round ahead and d added
//    to it at the round's start, so the new e is funnel shifts, a LOP3 and
//    one IADD3 deep.  The terms of b_i's first block that depend only on
//    its constant words 8-15 (K + W of rounds 8-15, the sigma terms of
//    schedule words 16, 17 and 24-30) come precomputed from the host; the
//    kernel compresses that block apart from the others.
// On an H100 80GB HBM3 at 700 W (32 bytes to 256, PERF.md): one lane's
// chain 0.0150 ms (0.0257 before), 256 lanes 0.0151 (0.0461), 2^16 lanes
// 0.0523 (0.299), 1.07 times the operation bound.  What holds the chain is
// one warp's issue of ~1,500 dependent instructions a compression, 40 %
// of them funnel shifts.  scripts/xmd_sqr_variants.py builds the
// alternatives, each slower: the host terms left out (up to 2 %), a
// warp's b_i staged through shared memory and stored as full sectors
// (1-3 %), every block through one compression site, one copy of the
// rounds in place of three (4-11 %).
//
// The C functions launch on the given stream, allocate nothing, do not
// synchronise and return cudaGetLastError().
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__constant__ uint32_t kK[64] = {
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
};

__constant__ uint32_t kH0[8] = {0x6A09E667, 0xBB67AE85, 0x3C6EF372,
                                0xA54FF53A, 0x510E527F, 0x9B05688C,
                                0x1F83D9AB, 0x5BE0CD19};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// One compression of the 16 words w into the state st (FIPS 180-4 6.2.2);
// w is the schedule's ring and is overwritten.
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      w[i & 15] += s0 + w[(i - 7) & 15] + s1;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + kK[i] + w[i & 15];
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// Absorb the last n data bytes of an input and its padding into st.  The
// input's first `done` bytes (a multiple of 64) are already in st; its
// data byte at position pos (0 <= pos < n, counted after those) is
// s.byte(pos), except that words 0 .. kRegWords-1 of the first block are
// regs[] (kRegWords <= n / 4).  Padding: 0x80, zeros, the input's bit
// length big-endian in the last 8 bytes of the last block.
template <int kRegWords, class S>
__device__ __forceinline__ void absorb(uint32_t st[8], const uint32_t* regs,
                                       const S& s, uint32_t n,
                                       uint64_t done) {
  const uint32_t padded = (n + 9 + 63) & ~63u;
  const uint64_t bits = (done + n) * 8;
  for (uint32_t blk = 0; blk < padded; blk += 64) {
    uint32_t w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < kRegWords && blk == 0) {
        w[j] = regs[j];
        continue;
      }
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t pos = blk + 4 * j + k;
        uint32_t v;
        if (pos < n)
          v = s.byte(pos);
        else if (pos == n)
          v = 0x80;
        else if (pos >= padded - 8)
          v = (uint32_t)(bits >> (8 * (padded - 1 - pos))) & 0xFF;
        else
          v = 0;
        word = (word << 8) | v;
      }
      w[j] = word;
    }
    compress(st, w);
  }
}

// The bytes of one message row.
struct RowBytes {
  const uint8_t* row;
  __device__ __forceinline__ uint32_t byte(uint32_t pos) const {
    return __ldg(row + pos);
  }
};

__device__ __forceinline__ void store_digest(uint8_t* out,
                                             const uint32_t st[8],
                                             uint32_t n) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * j + k < (int)n) out[4 * j + k] = (uint8_t)(st[j] >> (24 - 8 * k));
}

__global__ void __launch_bounds__(kThreads)
sha256_kernel(const uint8_t* __restrict__ msg, uint8_t* __restrict__ out,
              uint32_t msg_len, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint32_t st[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) st[j] = kH0[j];
  absorb<0>(st, nullptr, RowBytes{msg + (size_t)lane * msg_len}, msg_len, 0);
  store_digest(out + (size_t)lane * 32, st, 32);
}

// ---------------------------------------------------------------------------
// expand_message_xmd
// ---------------------------------------------------------------------------

constexpr int kMaxDstPrime = 256;  // a DST of at most 255 bytes, its length
// Parameter words (kernels/sha256.py XMD_B0_TAIL_WORDS, XMD_BI_TAIL_WORDS):
// b0's input from the message's last whole word on is at most 3 message
// bytes, 3 + 256 bytes of I2OSP(len, 2) || 0 || DST' and 72 of padding to
// the block: 332 bytes; b_i's input after its first 32 bytes at most 320
// - 32 = 288.  The whole XmdParams is 756 bytes of the launch's 4 KB.
constexpr int kB0TailWords = 84;
constexpr int kBiTailWords = 72;

// kernels/sha256.py packs this (`xmd_params`, struct "<16I84I72I8I9I").
struct XmdParams {
  uint32_t midstate[8];  // the state after the 64 zero bytes of Z_pad
  uint32_t msg_len;
  uint32_t len_in_bytes;
  uint32_t ell;  // ceil(len_in_bytes / 32), 1..255
  uint32_t dst_prime_len;
  uint32_t b0_blocks;  // blocks of b0's input after Z_pad
  uint32_t bi_blocks;  // blocks of each b_i's input
  uint32_t load;       // message loads of 16, 4 or 1 bytes (kLoad)
  uint32_t store;      // output stores of 16, 4 or 1 bytes
  // b0's input words after Z_pad from word msg_len / 4 on, big-endian, the
  // message's bytes in them zero
  uint32_t b0_tail[kB0TailWords];
  // b_i's input words from word 8 on, the byte of i zero
  uint32_t bi_tail[kBiTailWords];
  // b_i's first block, W[8] taken without i: K[t] + W[t] for t = 8..15;
  // W16 - sigma0(W1) - W0, W17 - sigma0(W2) - W1, then sigma0(W[u-15]) +
  // W[u-16] for u = 24..30
  uint32_t bi_kw[8];
  uint32_t bi_sched[9];
};
static_assert(sizeof(XmdParams) == 756, "XmdParams layout (kernels/sha256.py)");

__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

__device__ __forceinline__ uint32_t sigma0(uint32_t x) {
  return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3);
}

__device__ __forceinline__ uint32_t sigma1(uint32_t x) {
  return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10);
}

// K[u] + W[u] of round u; in b_i's first block (kBiFirst) rounds 8..15 take
// the host's sums, i8 = i << 24 added in round 8.
template <bool kBiFirst>
__device__ __forceinline__ uint32_t k_plus_w(int u, const uint32_t (&w)[16],
                                             const XmdParams& p,
                                             uint32_t i8) {
  if (kBiFirst && u >= 8 && u < 16)
    return p.bi_kw[u - 8] + (u == 8 ? i8 : 0u);
  return kK[u] + w[u & 15];
}

// Schedule word W[u], u >= 16, from the ring (w[u & 15] holds W[u-16]); in
// b_i's first block the host's terms of the constant words 8..15.
template <bool kBiFirst>
__device__ __forceinline__ uint32_t schedule(int u, const uint32_t (&w)[16],
                                             const XmdParams& p,
                                             uint32_t i8) {
  const uint32_t w16 = w[u & 15], w15 = w[(u - 15) & 15];
  const uint32_t w7 = w[(u - 7) & 15], w2 = w[(u - 2) & 15];
  if (kBiFirst) {
    if (u == 16 || u == 17) return p.bi_sched[u - 16] + sigma0(w15) + w16;
    if (u == 24) return sigma1(w2) + w7 + p.bi_sched[2] + i8;
    if (u >= 25 && u <= 30) return sigma1(w2) + w7 + p.bi_sched[u - 22];
  }
  return sigma1(w2) + w7 + sigma0(w15) + w16;
}

// One compression of the 16 words w into st (FIPS 180-4 6.2.2), w the
// schedule's ring (overwritten).  h + K + W is summed a round ahead and d
// added to it at the round's start: the new e is dh + S1 + ch, one IADD3
// after the funnel shifts and LOP3s of S1 and ch.
template <bool kBiFirst>
__device__ __forceinline__ void compress_xmd(uint32_t (&st)[8],
                                             uint32_t (&w)[16],
                                             const XmdParams& p,
                                             uint32_t i8) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
  uint32_t hkw = h + k_plus_w<kBiFirst>(0, w, p, i8);
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    const uint32_t dh = d + hkw;
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t1 = hkw + S1 + ch;
    if (t + 1 < 64) {  // the next round's h + K + W; its h is this g
      if (t + 1 >= 16) w[(t + 1) & 15] = schedule<kBiFirst>(t + 1, w, p, i8);
      hkw = g + k_plus_w<kBiFirst>(t + 1, w, p, i8);
    }
    h = g;
    g = f;
    f = e;
    e = dh + S1 + ch;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// OR the message's words base .. base + 15 (big-endian, bytes past msg_len
// zero) into w.  kLoad = 16 or 4: whole words (msg_len and the row's
// address multiples of kLoad), as 16-byte or 4-byte loads; kLoad = 1: byte
// loads, and the one word that ends the message (msg_len % 4 != 0)
// assembled from its bytes.
template <int kLoad>
__device__ __forceinline__ void or_message(const uint8_t* row,
                                           uint32_t msg_len, int base,
                                           uint32_t (&w)[16]) {
  const int whole = (int)(msg_len >> 2);
  if constexpr (kLoad == 16) {
    const uint4* v4 = reinterpret_cast<const uint4*>(row) + base / 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (base + 4 * q < whole) {
        const uint4 v = __ldg(v4 + q);
        w[4 * q] |= bswap(v.x);
        w[4 * q + 1] |= bswap(v.y);
        w[4 * q + 2] |= bswap(v.z);
        w[4 * q + 3] |= bswap(v.w);
      }
    }
  } else if constexpr (kLoad == 4) {
    const uint32_t* v = reinterpret_cast<const uint32_t*>(row) + base;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (base + j < whole) w[j] |= bswap(__ldg(v + j));
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int k = base + j;
      const uint32_t n = k < whole ? 4u : k == whole ? msg_len & 3u : 0u;
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if ((uint32_t)q < n)
          word |= (uint32_t)__ldg(row + 4 * k + q) << (24 - 8 * q);
      w[j] |= word;
    }
  }
}

// Words 16 blk .. 16 blk + 15 of b0's input after Z_pad.
template <int kLoad>
__device__ __forceinline__ void b0_block(const uint8_t* row,
                                         const XmdParams& p, int blk,
                                         uint32_t (&w)[16]) {
  const int base = 16 * blk, whole = (int)(p.msg_len >> 2);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int t = base + j - whole;  // the same on every thread
    w[j] = t >= 0 ? p.b0_tail[t] : 0u;
  }
  or_message<kLoad>(row, p.msg_len, base, w);
}

// Write n bytes (16 or 32 for store 16; 1..32 otherwise) of the state st,
// big-endian, at dst.
__device__ __forceinline__ void store_b(uint8_t* dst, const uint32_t (&st)[8],
                                        uint32_t n, uint32_t store) {
  if (store == 16) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(bswap(st[0]), bswap(st[1]), bswap(st[2]),
                      bswap(st[3]));
    if (n > 16)
      d[1] = make_uint4(bswap(st[4]), bswap(st[5]), bswap(st[6]),
                        bswap(st[7]));
  } else if (store == 4) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (4u * k < n) d[k] = bswap(st[k]);
  } else {
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if ((uint32_t)k < n) dst[k] = (uint8_t)(st[k / 4] >> (24 - 8 * (k % 4)));
  }
}

template <int kLoad>
__global__ void __launch_bounds__(kThreads)
xmd_sha256_kernel(const uint8_t* __restrict__ msg, uint8_t* __restrict__ out,
                  const __grid_constant__ XmdParams p, int B) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= B) return;
  const uint8_t* row = msg + (size_t)lane * p.msg_len;
  uint8_t* row_out = out + (size_t)lane * p.len_in_bytes;
  // b0 = H(Z_pad || msg || I2OSP(len, 2) || 0x00 || DST')
  uint32_t b0[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) b0[j] = p.midstate[j];
  for (int blk = 0; blk < (int)p.b0_blocks; ++blk) {
    uint32_t w[16];
    b0_block<kLoad>(row, p, blk, w);
    compress_xmd<false>(b0, w, p, 0);
  }
  // b_i = H((b0 ^ b_(i-1)) || I2OSP(i, 1) || DST'), b_0 taken as zero
  uint32_t b[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (uint32_t i = 1; i <= p.ell; ++i) {
    const uint32_t i8 = i << 24;
    uint32_t w[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      w[j] = b0[j] ^ b[j];
      w[8 + j] = p.bi_tail[j];
      b[j] = kH0[j];
    }
    w[8] |= i8;
    compress_xmd<true>(b, w, p, i8);
    for (int blk = 1; blk < (int)p.bi_blocks; ++blk) {
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = p.bi_tail[16 * blk - 8 + j];
      compress_xmd<false>(b, w, p, 0);
    }
    const uint32_t off = 32 * (i - 1);
    store_b(row_out + off, b, min(32u, p.len_in_bytes - off), p.store);
  }
}

// A width of 16 or 4 bytes needs the address and the row length to be its
// multiples.
bool aligned(const void* ptr, uint32_t row_bytes, uint32_t width) {
  if (width == 1) return true;
  if (width != 4 && width != 16) return false;
  return (uintptr_t)ptr % width == 0 && row_bytes % width == 0;
}

// Whether the kernel takes these parameters and pointers.
bool xmd_params_ok(const void* msg, const void* out, const XmdParams& p,
                   int B) {
  return B >= 1 && p.ell >= 1 && p.ell <= 255 && p.len_in_bytes <= 65535 &&
         32 * p.ell >= p.len_in_bytes && 32 * (p.ell - 1) < p.len_in_bytes &&
         p.dst_prime_len >= 1 && p.dst_prime_len <= kMaxDstPrime &&
         p.b0_blocks >= 1 && p.bi_blocks >= 1 &&
         16ull * p.b0_blocks >= p.msg_len / 4 + 1ull &&
         16ull * p.b0_blocks - p.msg_len / 4 <= (unsigned)kB0TailWords &&
         16ull * p.bi_blocks - 8 <= (unsigned)kBiTailWords &&
         aligned(msg, p.msg_len, p.load) &&
         aligned(out, p.len_in_bytes, p.store);
}

}  // namespace

extern "C" int bls_sha256(const void* msg, void* out, int msg_len, int B,
                          void* stream) {
  if (B < 1 || msg_len < 0) return (int)cudaErrorInvalidValue;
  const int grid = (B + kThreads - 1) / kThreads;
  sha256_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)msg, (uint8_t*)out, (uint32_t)msg_len, B);
  return (int)cudaGetLastError();
}

extern "C" int bls_expand_xmd_sha256(const void* msg, void* out,
                                     const void* params, int B,
                                     void* stream) {
  // params: a host XmdParams (a void pointer: the struct is internal)
  const XmdParams& p = *(const XmdParams*)params;
  if (!xmd_params_ok(msg, out, p, B)) return (int)cudaErrorInvalidValue;
  const int grid = (B + kThreads - 1) / kThreads;
  const auto s = (cudaStream_t)stream;
  const auto m = (const uint8_t*)msg;
  const auto o = (uint8_t*)out;
  if (p.load == 16)
    xmd_sha256_kernel<16><<<grid, kThreads, 0, s>>>(m, o, p, B);
  else if (p.load == 4)
    xmd_sha256_kernel<4><<<grid, kThreads, 0, s>>>(m, o, p, B);
  else
    xmd_sha256_kernel<1><<<grid, kThreads, 0, s>>>(m, o, p, B);
  return (int)cudaGetLastError();
}
