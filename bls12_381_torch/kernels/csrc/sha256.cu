// Batched SHA-256 and expand_message_xmd over SHA-256 (draft-16 §5.3.1),
// one thread per message (wrappers and notes: kernels/sha256.py).
//
//   bls_sha256: out[b] = SHA-256(msg[b]), msg uint8 [B, msg_len] (msg_len
//               may be 0), out uint8 [B, 32]
//   bls_expand_xmd_sha256: out[b] = expand_message_xmd(msg[b], DST,
//               len_in_bytes), msg uint8 [B, msg_len], out uint8
//               [B, len_in_bytes]; DST' = DST || I2OSP(len(DST), 1), ell
//               and the state after the Z_pad block come from the host in
//               one XmdParams (an oversize DST is reduced there first)
//
// Replaces bls12_381_tpu/kernels/sha256_jax.py:96 `sha256` and :113
// `expand_message_xmd_sha256`, which are jnp (XLA fuses them inside the
// jitted hash-to-curve graph), not Pallas kernels.
//
// What bounds it on this card.  A lane's work is a serial chain: every
// compression depends on the state the previous one left, and every
// b_i on b_(i-1).  A 32-byte message expanded to 256 bytes under a
// 10-byte DST is 9 compressions (b0 after the Z_pad midstate, b1..b8), each
// 64 rounds of at least 14 32-bit instructions (a LOP3 for ch, maj and
// each three-way xor, an IADD3 for each add of three, a funnel shift for
// each rotation) and 48 schedule words of 10: ~1400 a compression.  At
// hash to curve's 256 lanes that is 2 blocks on 2 of the 132 SMs, one warp
// per scheduler: neither the operations (~0.2 us of the card's 32-bit
// rate) nor the bytes (~0.02 us) come near the time, which is one
// thread's chain of dependent instructions.  At 2^16 lanes the card is
// full and the operation rate is the bound.
//
// What the design does about it.  Everything of a lane stays in
// registers: the eight state words, a 16-word ring of the message
// schedule, b0 and b_(i-1); rotations are single funnel shifts; the 64
// round constants sit in __constant__ memory, read as broadcasts (every
// thread is at the same round).  The first block of b0 (64 zero bytes) is
// the same for every message, so the host passes the state after it (the
// midstate) and no thread compresses it.  DST' (at most 256 bytes),
// msg_len, len_in_bytes and ell travel by value in one __grid_constant__
// struct, so the padding and the message assembly read them from the
// parameter bank and nothing is concatenated in device memory: message
// bytes are read from the lane's row and assembled big-endian in
// registers.  The launch adds one kernel per expansion where the plain
// version issues thousands of elementwise ones.
//
// The C functions launch on the given stream, allocate nothing, do not
// synchronise and return cudaGetLastError().
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDstPrime = 256;  // a DST of at most 255 bytes, its length

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

// kernels/sha256.py packs this (`xmd_params`, struct "<8I4I256s").
struct XmdParams {
  uint32_t midstate[8];  // the state after the 64 zero bytes of Z_pad
  uint32_t msg_len;
  uint32_t len_in_bytes;
  uint32_t ell;  // ceil(len_in_bytes / 32), 1..255
  uint32_t dst_prime_len;
  uint8_t dst_prime[kMaxDstPrime];
};
static_assert(sizeof(XmdParams) == 304, "XmdParams layout (kernels/sha256.py)");

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

// b0's input after Z_pad: msg || I2OSP(len_in_bytes, 2) || 0x00 || DST'.
struct B0Bytes {
  const uint8_t* row;
  const XmdParams* p;
  __device__ __forceinline__ uint32_t byte(uint32_t pos) const {
    const uint32_t m = p->msg_len;
    if (pos < m) return __ldg(row + pos);
    if (pos == m) return p->len_in_bytes >> 8;
    if (pos == m + 1) return p->len_in_bytes & 0xFF;
    if (pos == m + 2) return 0;
    return p->dst_prime[pos - m - 3];
  }
};

// b_i's input past its first 32 bytes (b0 ^ b_(i-1), from registers):
// I2OSP(i, 1) || DST'.
struct BiBytes {
  uint32_t i;
  const XmdParams* p;
  __device__ __forceinline__ uint32_t byte(uint32_t pos) const {
    return pos == 32 ? i : p->dst_prime[pos - 33];
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

__global__ void __launch_bounds__(kThreads)
xmd_sha256_kernel(const uint8_t* __restrict__ msg, uint8_t* __restrict__ out,
                  const __grid_constant__ XmdParams p, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  uint8_t* row_out = out + (size_t)lane * p.len_in_bytes;
  // b0 = H(Z_pad || msg || I2OSP(len, 2) || 0x00 || DST')
  uint32_t b0[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) b0[j] = p.midstate[j];
  absorb<0>(b0, nullptr, B0Bytes{msg + (size_t)lane * p.msg_len, &p},
            p.msg_len + 3 + p.dst_prime_len, 64);
  // b_i = H((b0 ^ b_(i-1)) || I2OSP(i, 1) || DST'), b_0 taken as zero
  uint32_t b[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (uint32_t i = 1; i <= p.ell; ++i) {
    uint32_t x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j] = b0[j] ^ b[j];
      b[j] = kH0[j];
    }
    absorb<8>(b, x, BiBytes{i, &p}, 33 + p.dst_prime_len, 0);
    const uint32_t off = 32 * (i - 1);
    store_digest(row_out + off, b, p.len_in_bytes - off);
  }
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
  if (B < 1 || p.ell < 1 || p.ell > 255 || p.len_in_bytes > 65535 ||
      32 * p.ell < p.len_in_bytes || 32 * (p.ell - 1) >= p.len_in_bytes ||
      p.dst_prime_len < 1 || p.dst_prime_len > kMaxDstPrime)
    return (int)cudaErrorInvalidValue;
  const int grid = (B + kThreads - 1) / kThreads;
  xmd_sha256_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)msg, (uint8_t*)out, p, B);
  return (int)cudaGetLastError();
}
