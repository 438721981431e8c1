// Native host-side runtime of bls12_381_torch: batch byte codecs, Montgomery
// conversions, and SHA-256 / expand_message_xmd.  The C++ analogue of the
// reference's host-side material (fp.rs byte codecs, expand_msg.rs) for
// batch throughput, where Python big-int loops would hold the host back.
// Built for the host CPU by `kernels/build.py` (`build_host`) and bound by
// `utils/native.py`; no device code.
//
// Field element wire formats (reference notes/serialization.rs):
//   Fp:  48-byte big-endian canonical     -> 24 x 16-bit limbs (LE) in u32
//   Fr:  32-byte little-endian canonical  -> 16 x 16-bit limbs (LE) in u32
// Device-internal form is Montgomery (R = 2^384 / 2^256), identical to the
// reference's domain.

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

using u8 = uint8_t;
using u32 = uint32_t;
using u64 = uint64_t;
using u128 = unsigned __int128;

// ---------------------------------------------------------------------------
// 384-bit field arithmetic on 6 x u64 (host side only)
// ---------------------------------------------------------------------------

struct Fp6x64 {
    u64 l[6];
};

static const Fp6x64 FP_MOD = {{
    0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL,
    0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL,
}};
// -p^-1 mod 2^64
static const u64 FP_INV = 0x89f3fffcfffcfffdULL;
// R^2 mod p (Montgomery conversion constant)
static const Fp6x64 FP_R2 = {{
    0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL, 0x8de5476c4c95b6d5ULL,
    0x67eb88a9939d83c0ULL, 0x9a793e85b519952dULL, 0x11988fe592cae3aaULL,
}};

static inline u64 adc(u64 a, u64 b, u64 &carry) {
    u128 t = (u128)a + b + carry;
    carry = (u64)(t >> 64);
    return (u64)t;
}

static inline u64 sbb(u64 a, u64 b, u64 &borrow) {
    u128 t = (u128)a - b - (borrow >> 63);
    borrow = (u64)(t >> 64);  // 0 or all-ones
    return (u64)t;
}

static inline u64 mac(u64 a, u64 b, u64 c, u64 &carry) {
    u128 t = (u128)b * c + a + carry;
    carry = (u64)(t >> 64);
    return (u64)t;
}

// subtract p if >= p
static void fp_cond_sub(Fp6x64 &a) {
    u64 borrow = 0;
    Fp6x64 d;
    for (int i = 0; i < 6; i++) d.l[i] = sbb(a.l[i], FP_MOD.l[i], borrow);
    if (borrow == 0) a = d;
}

// CIOS Montgomery product (HAC 14.36 family; independent implementation)
static Fp6x64 fp_mont_mul(const Fp6x64 &a, const Fp6x64 &b) {
    u64 t[8] = {0};
    for (int i = 0; i < 6; i++) {
        u64 carry = 0;
        for (int j = 0; j < 6; j++) t[j] = mac(t[j], a.l[i], b.l[j], carry);
        u64 t6 = t[6] + carry;
        u64 t7 = (t6 < carry) ? 1 : 0;
        u64 m = t[0] * FP_INV;
        carry = 0;
        (void)mac(t[0], m, FP_MOD.l[0], carry);
        for (int j = 1; j < 6; j++) t[j - 1] = mac(t[j], m, FP_MOD.l[j], carry);
        u64 s = t6 + carry;
        t[5] = s;
        t[6] = t7 + ((s < carry) ? 1 : 0);
    }
    Fp6x64 r;
    for (int i = 0; i < 6; i++) r.l[i] = t[i];
    // t[6] can be at most 1; fold by conditional subtractions
    if (t[6]) {
        u64 borrow = 0;
        for (int i = 0; i < 6; i++) r.l[i] = sbb(r.l[i], FP_MOD.l[i], borrow);
    }
    fp_cond_sub(r);
    return r;
}

static bool fp_is_canonical(const Fp6x64 &a) {
    u64 borrow = 0;
    for (int i = 0; i < 6; i++) (void)sbb(a.l[i], FP_MOD.l[i], borrow);
    return borrow != 0;  // a < p iff the subtraction borrows
}

// ---------------------------------------------------------------------------
// SHA-256 (self-contained; FIPS 180-4)
// ---------------------------------------------------------------------------

struct Sha256 {
    u32 h[8];
    u8 buf[64];
    u64 len;
    size_t buflen;
};

static const u32 K256[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};

static inline u32 rotr(u32 x, int n) { return (x >> n) | (x << (32 - n)); }

static void sha256_init(Sha256 &s) {
    static const u32 iv[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                              0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    memcpy(s.h, iv, sizeof(iv));
    s.len = 0;
    s.buflen = 0;
}

static void sha256_block(Sha256 &s, const u8 *p) {
    u32 w[64];
    for (int i = 0; i < 16; i++)
        w[i] = (u32)p[4 * i] << 24 | (u32)p[4 * i + 1] << 16 |
               (u32)p[4 * i + 2] << 8 | p[4 * i + 3];
    for (int i = 16; i < 64; i++) {
        u32 s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
        u32 s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    u32 a = s.h[0], b = s.h[1], c = s.h[2], d = s.h[3];
    u32 e = s.h[4], f = s.h[5], g = s.h[6], h = s.h[7];
    for (int i = 0; i < 64; i++) {
        u32 S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
        u32 ch = (e & f) ^ (~e & g);
        u32 t1 = h + S1 + ch + K256[i] + w[i];
        u32 S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
        u32 maj = (a & b) ^ (a & c) ^ (b & c);
        u32 t2 = S0 + maj;
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    s.h[0] += a; s.h[1] += b; s.h[2] += c; s.h[3] += d;
    s.h[4] += e; s.h[5] += f; s.h[6] += g; s.h[7] += h;
}

static void sha256_update(Sha256 &s, const u8 *data, size_t n) {
    s.len += n;
    while (n) {
        size_t take = 64 - s.buflen;
        if (take > n) take = n;
        memcpy(s.buf + s.buflen, data, take);
        s.buflen += take;
        data += take;
        n -= take;
        if (s.buflen == 64) {
            sha256_block(s, s.buf);
            s.buflen = 0;
        }
    }
}

static void sha256_final(Sha256 &s, u8 out[32]) {
    u64 bitlen = s.len * 8;
    u8 pad = 0x80;
    sha256_update(s, &pad, 1);
    u8 z = 0;
    while (s.buflen != 56) sha256_update(s, &z, 1);
    u8 lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = (u8)(bitlen >> (56 - 8 * i));
    sha256_update(s, lenb, 8);
    for (int i = 0; i < 8; i++) {
        out[4 * i] = (u8)(s.h[i] >> 24);
        out[4 * i + 1] = (u8)(s.h[i] >> 16);
        out[4 * i + 2] = (u8)(s.h[i] >> 8);
        out[4 * i + 3] = (u8)(s.h[i]);
    }
}

static void sha256_oneshot(const u8 *d1, size_t n1, const u8 *d2, size_t n2,
                           const u8 *d3, size_t n3, u8 out[32]) {
    Sha256 s;
    sha256_init(s);
    if (n1) sha256_update(s, d1, n1);
    if (n2) sha256_update(s, d2, n2);
    if (n3) sha256_update(s, d3, n3);
    sha256_final(s, out);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Batch Fp codec: 48-byte BE canonical <-> 24 x u32 limbs (16-bit), with
// optional Montgomery conversion.  Limb layout matches the device: limb axis
// FIRST, i.e. out[limb * n + elem].
// ---------------------------------------------------------------------------

int bls_fp_from_bytes(const u8 *bytes, size_t n, int to_mont, u32 *limbs_out,
                      u8 *ok_out) {
    for (size_t e = 0; e < n; e++) {
        const u8 *src = bytes + 48 * e;
        Fp6x64 v;
        for (int i = 0; i < 6; i++) {
            u64 w = 0;
            for (int j = 0; j < 8; j++) w = w << 8 | src[8 * (5 - i) + j];
            v.l[i] = w;
        }
        ok_out[e] = fp_is_canonical(v) ? 1 : 0;
        if (!ok_out[e]) {
            // zero out non-canonical entries (callers mask)
            memset(&v, 0, sizeof(v));
        }
        if (to_mont) v = fp_mont_mul(v, FP_R2);
        for (int i = 0; i < 24; i++)
            limbs_out[(size_t)i * n + e] = (u32)((v.l[i / 4] >> (16 * (i % 4))) & 0xffff);
    }
    return 0;
}

int bls_fp_to_bytes(const u32 *limbs, size_t n, int from_mont, u8 *bytes_out) {
    for (size_t e = 0; e < n; e++) {
        Fp6x64 v = {{0, 0, 0, 0, 0, 0}};
        for (int i = 0; i < 24; i++)
            v.l[i / 4] |= (u64)(limbs[(size_t)i * n + e] & 0xffff)
                          << (16 * (i % 4));
        if (from_mont) {
            Fp6x64 one = {{1, 0, 0, 0, 0, 0}};
            v = fp_mont_mul(v, one);
        }
        u8 *dst = bytes_out + 48 * e;
        for (int i = 0; i < 6; i++)
            for (int j = 0; j < 8; j++)
                dst[8 * (5 - i) + j] = (u8)(v.l[i] >> (56 - 8 * j));
    }
    return 0;
}

// ---------------------------------------------------------------------------
// expand_message_xmd with SHA-256 (draft-16 §5.3.1; reference
// expand_msg.rs:230-328), batched over messages.
// msgs: concatenated message bytes; offsets: n+1 cumulative offsets.
// out: n * len_in_bytes bytes.
// ---------------------------------------------------------------------------

int bls_expand_msg_xmd_sha256(const u8 *msgs, const u64 *offsets, size_t n,
                              const u8 *dst, size_t dst_len, size_t len_in_bytes,
                              u8 *out) {
    if (len_in_bytes > 65535) return -1;
    size_t ell = (len_in_bytes + 31) / 32;
    if (ell > 255) return -1;

    u8 dst_red[32];
    const u8 *dst_use = dst;
    size_t dst_use_len = dst_len;
    if (dst_len > 255) {
        static const char tag[] = "H2C-OVERSIZE-DST-";
        Sha256 s;
        sha256_init(s);
        sha256_update(s, (const u8 *)tag, sizeof(tag) - 1);
        sha256_update(s, dst, dst_len);
        sha256_final(s, dst_red);
        dst_use = dst_red;
        dst_use_len = 32;
    }
    u8 dst_prime[256];
    memcpy(dst_prime, dst_use, dst_use_len);
    dst_prime[dst_use_len] = (u8)dst_use_len;
    size_t dst_prime_len = dst_use_len + 1;

    const u8 z_pad[64] = {0};
    for (size_t e = 0; e < n; e++) {
        const u8 *msg = msgs + offsets[e];
        size_t msg_len = offsets[e + 1] - offsets[e];
        u8 b0[32], bi[32];
        {
            Sha256 s;
            sha256_init(s);
            sha256_update(s, z_pad, 64);
            sha256_update(s, msg, msg_len);
            u8 lib[3] = {(u8)(len_in_bytes >> 8), (u8)len_in_bytes, 0};
            sha256_update(s, lib, 3);
            sha256_update(s, dst_prime, dst_prime_len);
            sha256_final(s, b0);
        }
        u8 *dst_out = out + e * len_in_bytes;
        u8 ctr = 1;
        sha256_oneshot(b0, 32, &ctr, 1, dst_prime, dst_prime_len, bi);
        size_t written = 0;
        for (size_t i = 1;; i++) {
            size_t take = len_in_bytes - written;
            if (take > 32) take = 32;
            memcpy(dst_out + written, bi, take);
            written += take;
            if (written >= len_in_bytes) break;
            u8 x[32];
            for (int j = 0; j < 32; j++) x[j] = b0[j] ^ bi[j];
            ctr = (u8)(i + 1);
            sha256_oneshot(x, 32, &ctr, 1, dst_prime, dst_prime_len, bi);
        }
    }
    return 0;
}

}  // extern "C"
