// Batched SHAKE sponge over Keccak-f[1600], one thread per message
// (wrappers and notes: kernels/keccak.py).
//
//   bls_shake: out[b] = the first out_len bytes squeezed from the sponge
//              of rate `rate` after absorbing msg[b] || suffix with the
//              domain byte; msg uint8 [B, msg_len] (msg_len may be 0),
//              out uint8 [B, out_len].  SHAKE-128 is rate 168, SHAKE-256
//              rate 136, domain 0x1F.  expand_message_xof (draft-16
//              §5.3.2) passes I2OSP(len_in_bytes, 2) || DST ||
//              I2OSP(len(DST), 1) as the suffix.
//
// Replaces bls12_381_tpu/kernels/keccak_jax.py:122 `shake` and :164
// `expand_message_xof_shake`, which are jnp (fused by XLA), not Pallas
// kernels.
//
// What bounds it on this card.  A lane is a serial chain of
// permutations, 24 rounds each, each round at least 180 32-bit
// instructions on the lanes' halves (a five-way xor two LOP3, theta's
// a ^= D one, chi one, a 64-bit rotation two funnel shifts).
// At the widths of a hash to curve (hundreds of lanes) the launch fills a
// few SMs and its time is one thread's chain; at 2^16 lanes the card is
// full and the 32-bit operation rate is the bound.  Bytes are a message
// and an output per lane, far below either.
//
// What the design does about it.  The 25 lanes are native uint64_t in
// registers (the JAX package splits each into two uint32 halves only
// because the TPU has no 64-bit integers, keccak_jax.py:3-4); a round is
// written out with the rho offsets and the pi permutation fixed at
// compile time, so every rotation is two funnel shifts and no state word
// touches memory; the 24 round constants sit in __constant__ memory
// (every thread reads the same one: a broadcast).  The rate, domain byte,
// output length and the suffix (at most 258 bytes) travel by value in one
// __grid_constant__ struct: message bytes are read from the lane's row,
// the suffix and the padding from the parameter bank, and nothing is
// concatenated in device memory.
//
// The C function launches on the given stream, allocates nothing, does not
// synchronise and returns cudaGetLastError().
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLanes = 21;    // rate 168 (SHAKE-128)
constexpr int kMaxSuffix = 260;  // I2OSP(len, 2) || 255-byte DST || 1 byte

__constant__ uint64_t kRC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

// kernels/keccak.py packs this (`_SHAKE_PARAMS`, struct "<5I260s").
struct ShakeParams {
  uint32_t msg_len;
  uint32_t out_len;
  uint32_t rate;  // bytes, a multiple of 8, at most 8 * kMaxLanes
  uint32_t domain;
  uint32_t suffix_len;
  uint8_t suffix[kMaxSuffix];
};
static_assert(sizeof(ShakeParams) == 280, "ShakeParams layout (keccak.py)");

template <int N>
__device__ __forceinline__ uint64_t rotl(uint64_t x) {
  if constexpr (N == 0)
    return x;
  else
    return (x << N) | (x >> (64 - N));
}

// Keccak-f[1600] on the lanes a[x + 5 y].
__device__ __forceinline__ void keccak_f(uint64_t a[25]) {
  for (int r = 0; r < 24; ++r) {
    // theta
    uint64_t c[5], d[5];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) d[x] = c[(x + 4) % 5] ^ rotl<1>(c[(x + 1) % 5]);
#pragma unroll
    for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];
    // rho and pi: b[y + 5 ((2 x + 3 y) % 5)] = rotl(a[x + 5 y], rho[x][y])
    uint64_t b[25];
    b[0] = rotl<0>(a[0]);
    b[1] = rotl<44>(a[6]);
    b[2] = rotl<43>(a[12]);
    b[3] = rotl<21>(a[18]);
    b[4] = rotl<14>(a[24]);
    b[5] = rotl<28>(a[3]);
    b[6] = rotl<20>(a[9]);
    b[7] = rotl<3>(a[10]);
    b[8] = rotl<45>(a[16]);
    b[9] = rotl<61>(a[22]);
    b[10] = rotl<1>(a[1]);
    b[11] = rotl<6>(a[7]);
    b[12] = rotl<25>(a[13]);
    b[13] = rotl<8>(a[19]);
    b[14] = rotl<18>(a[20]);
    b[15] = rotl<27>(a[4]);
    b[16] = rotl<36>(a[5]);
    b[17] = rotl<10>(a[11]);
    b[18] = rotl<15>(a[17]);
    b[19] = rotl<56>(a[23]);
    b[20] = rotl<62>(a[2]);
    b[21] = rotl<55>(a[8]);
    b[22] = rotl<39>(a[14]);
    b[23] = rotl<41>(a[15]);
    b[24] = rotl<2>(a[21]);
    // chi
#pragma unroll
    for (int y = 0; y < 25; y += 5)
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
    // iota
    a[0] ^= kRC[r];
  }
}

__global__ void __launch_bounds__(kThreads)
shake_kernel(const uint8_t* __restrict__ msg, uint8_t* __restrict__ out,
             const __grid_constant__ ShakeParams p, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const uint8_t* row = msg + (size_t)lane * p.msg_len;
  uint8_t* row_out = out + (size_t)lane * p.out_len;
  const uint32_t m = p.msg_len, n = m + p.suffix_len, rate = p.rate;
  const uint32_t lanes = rate / 8;
  // pad10*1 with the domain byte: at least one byte, to a multiple of rate
  const uint32_t padded = n + (rate - n % rate);
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) a[i] = 0;
  for (uint32_t blk = 0; blk < padded; blk += rate) {
#pragma unroll
    for (int j = 0; j < kMaxLanes; ++j) {
      if (j >= (int)lanes) break;
      uint64_t v = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t pos = blk + 8 * j + k;
        uint32_t byte;
        if (pos < m)
          byte = __ldg(row + pos);
        else if (pos < n)
          byte = p.suffix[pos - m];
        else
          byte = (pos == n ? p.domain : 0u) | (pos == padded - 1 ? 0x80u : 0u);
        v |= (uint64_t)byte << (8 * k);
      }
      a[j] ^= v;
    }
    keccak_f(a);
  }
  for (uint32_t off = 0;;) {
#pragma unroll
    for (int j = 0; j < kMaxLanes; ++j) {
      if (j >= (int)lanes) break;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t pos = off + 8 * j + k;
        if (pos < p.out_len) row_out[pos] = (uint8_t)(a[j] >> (8 * k));
      }
    }
    off += rate;
    if (off >= p.out_len) break;
    keccak_f(a);
  }
}

}  // namespace

extern "C" int bls_shake(const void* msg, void* out, const void* params,
                         int B, void* stream) {
  // params: a host ShakeParams (a void pointer: the struct is internal)
  const ShakeParams& p = *(const ShakeParams*)params;
  if (B < 1 || p.out_len < 1 || p.rate < 8 || p.rate > 8 * kMaxLanes ||
      p.rate % 8 != 0 || p.domain > 0xFF || p.suffix_len > kMaxSuffix)
    return (int)cudaErrorInvalidValue;
  const int grid = (B + kThreads - 1) / kThreads;
  shake_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)msg, (uint8_t*)out, p, B);
  return (int)cudaGetLastError();
}
