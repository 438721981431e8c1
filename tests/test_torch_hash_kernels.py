"""The device hash expanders' plain versions and wrappers
(`kernels/sha256.py`, `kernels/keccak.py`), on the CPU.

The plain SHA-256, expand_message_xmd, SHAKE and expand_message_xof are
held to hashlib (through `hostmath`) at the lengths of
`tests/port_cases.py` at which the card tests run the kernels, and to the JAX package's
`sha256_jax` / `keccak_jax` (jnp on the CPU) at the edge lengths; the XMD
kernel's host-side parameters (`sha256.xmd_params`) to the JAX package's
compression and hostmath; the wrappers' ValueErrors, and that a CPU call
counts no launch.  The kernels themselves run on the card only
(`tests/test_torch_kernels_gpu.py`).  Inputs from a numpy seed.
Tolerance: none -- bytes compare exactly.
"""

import hashlib
import struct

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
import jax.numpy as jnp
from bls12_381_tpu.kernels import keccak_jax, sha256_jax

import port_cases
from bls12_381_torch import entry, hostmath as hm
from bls12_381_torch.kernels import LAUNCHES, keccak, sha256

torch.set_num_threads(1)
SEED = 20261017
LANES = 3
DST = port_cases.HASH_DST


def messages(length: int, lanes: int = LANES) -> np.ndarray:
    rng = np.random.default_rng(SEED + length)
    return rng.integers(0, 256, (lanes, length), dtype=np.uint8)


def dst_of(length: int) -> bytes:
    if length == len(DST):
        return DST
    return bytes(np.random.default_rng(length).integers(0, 256, length,
                                                        dtype=np.uint8))


def rows(t) -> list:
    return [bytes(r) for r in np.asarray(t)]


# --- SHA-256 and expand_message_xmd ----------------------------------------


# the JAX comparisons (eager jnp: ~0.15 s a compression) at the edges: the
# padding's length field in the same block (55) or the next (56), two
# blocks and three
JAX_MSG_LENS = (0, 55, 56, 119, 120)


@pytest.mark.parametrize("msg_len", port_cases.XMD_MSG_LENS)
def test_plain_sha256_matches_hashlib_and_jax(msg_len):
    m = messages(msg_len)
    got = rows(sha256.sha256(torch.from_numpy(m)))
    assert got == [hashlib.sha256(bytes(r)).digest() for r in m]
    if msg_len in JAX_MSG_LENS:
        assert got == rows(sha256_jax.sha256(jnp.asarray(m)))


@pytest.mark.parametrize("msg_len,out_len,dst_len", port_cases.xmd_cases())
def test_plain_xmd_matches_hashlib(msg_len, out_len, dst_len):
    """Phase hashes' cases: b0 over one to three blocks, ell up to 255,
    DSTs up to one reduced on the host."""
    m, dst = messages(msg_len), dst_of(dst_len)
    got = sha256.expand_message_xmd_sha256(torch.from_numpy(m), dst,
                                           out_len)
    assert rows(got) == [hm.expand_message_xmd(bytes(r), dst, out_len)
                         for r in m]


@pytest.mark.parametrize("msg_len,out_len,dst_len", [
    (m, 32, len(DST)) for m in JAX_MSG_LENS] + [
    (32, 48, 43), (32, 32, 255), (32, 32, 300)])
def test_plain_xmd_matches_jax(msg_len, out_len, dst_len):
    m, dst = messages(msg_len), dst_of(dst_len)
    got = sha256.expand_message_xmd_sha256(torch.from_numpy(m), dst,
                                           out_len)
    assert rows(got) == rows(sha256_jax.expand_message_xmd_sha256(
        jnp.asarray(m), dst, out_len))


def test_phase_hashes_times_the_h2c_rows_dst():
    assert DST == entry.H2C_DST


XMD_LAYOUT = "<16I84I72I8I9I"  # csrc/sha256.cu XmdParams, 756 bytes


# --- a word-level model of csrc/sha256.cu's xmd_sha256_kernel ---------------

M32 = sha256.M32


def rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & M32


def small_sigma(x: int, which: int) -> int:
    """sigma0 (which 0) or sigma1 (which 1) of FIPS 180-4."""
    if which == 0:
        return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3)
    return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10)


def compress_words(st, w, first=None):
    """The kernel's compress_xmd on Python ints: round t's K[t] + W[t] and
    schedule word W[u] as `k_plus_w` and `schedule` form them; first =
    (kw, sched, i8) for b_i's first block (the host's terms)."""
    w = list(w)
    for u in range(16, 64):
        if first and u in (16, 17):
            v = first[1][u - 16] + small_sigma(w[u - 15], 0) + w[u - 16]
        elif first and u == 24:
            v = small_sigma(w[u - 2], 1) + w[u - 7] + first[1][2] + first[2]
        elif first and 25 <= u <= 30:
            v = small_sigma(w[u - 2], 1) + w[u - 7] + first[1][u - 22]
        else:
            v = (small_sigma(w[u - 2], 1) + w[u - 7]
                 + small_sigma(w[u - 15], 0) + w[u - 16])
        w.append(v & M32)
    a, b, c, d, e, f, g, h = st
    for t in range(64):
        if first and 8 <= t < 16:
            kw = first[0][t - 8] + (first[2] if t == 8 else 0)
        else:
            kw = sha256._K[t] + w[t]
        s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t1 = h + kw + s1 + ch
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & M32, c, b, a,
                                  (t1 + s0 + maj) & M32)
    return [(x + y) & M32 for x, y in zip(st, (a, b, c, d, e, f, g, h))]


def xmd_word_model(params: bytes, msgs) -> list:
    """expand_message_xmd of each row of msgs (uint8 [B, msg_len]) from
    the packed XmdParams alone, word by word as the kernel builds its
    blocks (the instance of the packed load width)."""
    f = struct.unpack(XMD_LAYOUT, params)
    midstate, (msg_len, out_len, ell, _, b0_blocks, bi_blocks, load,
               _) = f[:8], f[8:16]
    b0_tail, bi_tail = f[16:100], f[100:172]
    first = (f[172:180], f[180:189])
    whole = msg_len // 4
    out = []
    for row in msgs:
        row = bytes(row)
        b0 = list(midstate)
        for blk in range(b0_blocks):
            base = 16 * blk
            w = [b0_tail[base + j - whole] if base + j >= whole else 0
                 for j in range(16)]
            for j in range(16):
                k = base + j
                if k < whole:
                    w[j] |= int.from_bytes(row[4 * k:4 * k + 4], "big")
                elif k == whole and msg_len % 4:
                    assert load == 1
                    w[j] |= int.from_bytes(row[4 * k:].ljust(4, b"\0"),
                                           "big")
            b0 = compress_words(b0, w)
        b, okm = [0] * 8, b""
        for i in range(1, ell + 1):
            w = [x ^ y for x, y in zip(b0, b)] + list(bi_tail[:8])
            w[8] |= i << 24
            b = compress_words(list(sha256._H0), w, first + (i << 24,))
            for blk in range(1, bi_blocks):
                b = compress_words(b, bi_tail[16 * blk - 8:16 * blk + 8])
            okm += struct.pack(">8I", *b)
        out.append(okm[:out_len])
    return out




def xmd_fields(dst: bytes, len_in_bytes: int, msg_len: int):
    """`sha256.xmd_params` unpacked: (midstate, msg_len, len_in_bytes, ell,
    len(DST'), DST' as packed: bytes 1.. of b_i's parameter words)."""
    f = struct.unpack(XMD_LAYOUT, sha256.xmd_params(dst, len_in_bytes,
                                                    msg_len))
    n = f[11]
    bi_tail = struct.pack(">72I", *f[100:172])
    return (f[:8],) + f[8:12] + (bi_tail[1:1 + n],)


def test_xmd_params_midstate_is_the_compression_of_zpad():
    """The midstate the kernel starts b0 from: the plain compression of
    64 zero bytes from H0, as the JAX package's compression gives it."""
    state = [jnp.uint32(h) for h in sha256_jax._H0]
    want = tuple(int(w) for w in sha256_jax._compress(
        state, [jnp.uint32(0)] * 16))
    midstate, msg_len, len_in_bytes, ell, n, dst_prime = xmd_fields(DST, 256,
                                                                     32)
    assert midstate == want == sha256.zpad_midstate()
    assert (dst_prime[:n], ell, msg_len, len_in_bytes) == (
        DST + bytes([len(DST)]), 8, 32, 256)


@pytest.mark.parametrize("out_len,ell", [(1, 1), (32, 1), (33, 2),
                                         (48, 2), (256, 8), (8160, 255)])
def test_xmd_params_ell(out_len, ell):
    assert xmd_fields(DST, out_len, 0)[3] == ell == sha256.xmd_ell(out_len)


def test_xmd_params_reduce_an_oversize_dst_as_hostmath_does():
    dst = dst_of(300)
    *_, n, dst_prime = xmd_fields(dst, 64, 5)
    reduced = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    assert dst_prime[:n] == reduced + bytes([32])
    m = messages(5)
    assert rows(sha256.expand_message_xmd_sha256(torch.from_numpy(m),
                                                 reduced, 64)) == [
        hm.expand_message_xmd(bytes(r), dst, 64) for r in m]
    *_, n, dst_prime = xmd_fields(dst_of(255), 64, 5)
    assert dst_prime[:n] == dst_of(255) + bytes([255])


def test_xmd_params_pack_layout():
    """csrc/sha256.cu's XmdParams: 8 midstate words; msg_len, len_in_bytes,
    ell, len(DST'), b0's blocks after Z_pad, b_i's blocks, the load and
    store widths; b0's input words after Z_pad from the message's last
    whole word on (84, the message's bytes zero), b_i's from its word 8 on
    (72, the byte of i zero), big-endian and zero-padded; K[t] + W[t] of
    b_i's first block for t = 8..15 and its schedule terms (W[8] without
    i)."""
    blob = sha256.xmd_params(DST, 200, 7, 4, 16)
    assert len(blob) == struct.calcsize(XMD_LAYOUT) == 756
    f = struct.unpack(XMD_LAYOUT, blob)
    dst_prime = DST + bytes([len(DST)])
    # b0: 64 + 7 + 3 + 11 = 85 bytes, one block after Z_pad; b_i: 33 + 11
    assert f[:8] == sha256.zpad_midstate()
    assert f[8:16] == (7, 200, 7, len(dst_prime), 1, 1, 4, 16)
    b0 = (bytes(3) + (200).to_bytes(2, "big") + b"\0" + dst_prime + b"\x80"
          + bytes(34) + (85 * 8).to_bytes(8, "big"))     # data bytes 4..63
    assert struct.pack(">84I", *f[16:100]) == b0.ljust(336, b"\0")
    bi = (b"\0" + dst_prime + b"\x80" + bytes(11)
          + (44 * 8).to_bytes(8, "big"))                 # bytes 32..63
    assert struct.pack(">72I", *f[100:172]) == bi.ljust(288, b"\0")
    w = [0] * 8 + list(struct.unpack(">8I", bi))
    assert list(f[172:180]) == [(sha256._K[t] + w[t]) & sha256.M32
                                for t in range(8, 16)]
    sched = [small_sigma(w[14], 1) + w[9], small_sigma(w[15], 1) + w[10]]
    sched += [small_sigma(w[u - 15], 0) + w[u - 16] for u in range(24, 31)]
    assert list(f[180:189]) == [v & M32 for v in sched]


def test_io_width():
    """The load and store widths: the widest of 16, 4, 1 dividing both the
    address and the row length."""
    assert [sha256.io_width(a, n) for a, n in (
        (256, 32), (256, 0), (260, 32), (257, 32), (256, 36), (256, 55))] == [
        16, 16, 4, 1, 4, 1]


@pytest.mark.parametrize("msg_len,out_len,dst_len", port_cases.xmd_cases())
def test_xmd_word_model_matches_hashlib(msg_len, out_len, dst_len):
    """From the packed words alone, the kernel's word-level assembly (b0's
    blocks: parameter words at a uniform index, message words OR-ed in at
    every load width the length admits, the boundary word of a length not a
    multiple of 4 from its bytes; b_i's first block: b0 ^ b_(i-1), the
    parameter words with i << 24 OR-ed into word 8, the host's K + W and
    schedule terms; its other blocks: parameter words) gives hashlib's
    expand_message_xmd on every lane."""
    m, dst = messages(msg_len), dst_of(dst_len)
    want = [hm.expand_message_xmd(bytes(r), dst, out_len) for r in m]
    for load in (16, 4, 1):
        if msg_len % load == 0:
            params = sha256.xmd_params(dst, out_len, msg_len, load, 1)
            assert xmd_word_model(params, m) == want, load


@pytest.mark.parametrize("out_len", [8161, 65536, -1])
def test_xmd_bounds_raise(out_len):
    with pytest.raises(ValueError):
        sha256.xmd_params(DST, out_len, 0)
    with pytest.raises(ValueError):
        sha256.expand_message_xmd_sha256(messages(4), DST, out_len,
                                         device="cpu")


# --- SHAKE and expand_message_xof -------------------------------------------


@pytest.mark.parametrize("rate,msg_len,out_len", port_cases.shake_cases())
def test_plain_shake_matches_hashlib(rate, msg_len, out_len):
    m = messages(msg_len)
    name = {168: "shake_128", 136: "shake_256"}[rate]
    got = keccak.shake(torch.from_numpy(m), out_len, rate)
    assert rows(got) == [hashlib.new(name, bytes(r)).digest(out_len)
                         for r in m]


@pytest.mark.parametrize("rate,msg_len", [
    (r, m) for r in port_cases.SHAKE_RATES
    for m in (r - 1, r, r + 1)])
def test_plain_shake_matches_jax(rate, msg_len):
    """The padding's edges (the domain byte and 0x80 in one byte, a block
    of padding alone, one byte over), squeezing past one block (r + 1
    bytes out)."""
    m = messages(msg_len)
    got = keccak.shake(torch.from_numpy(m), rate + 1, rate)
    assert rows(got) == rows(keccak_jax.shake(jnp.asarray(m), rate + 1,
                                              rate))


@pytest.mark.parametrize("bits", [128, 256])
@pytest.mark.parametrize("dst_len", [len(DST), 300])
def test_plain_xof_matches_hostmath_and_jax(bits, dst_len):
    m, dst = messages(32), dst_of(dst_len)
    got = rows(keccak.expand_message_xof_shake(torch.from_numpy(m), dst, 128,
                                               bits=bits))
    assert got == [hm.expand_message_xof(bytes(r), dst, 128,
                                         hash_name=f"shake_{bits}")
                   for r in m]
    assert got == rows(keccak_jax.expand_message_xof_shake(
        jnp.asarray(m), dst, 128, bits=bits))


@pytest.mark.parametrize("out_len,rate,domain", [
    (0, 168, 0x1F), (16, 100, 0x1F), (16, 176, 0x1F), (16, 0, 0x1F),
    (16, 136, 256)])
def test_shake_arguments_raise(out_len, rate, domain):
    with pytest.raises(ValueError):
        keccak.shake(torch.from_numpy(messages(4)), out_len, rate, domain)


# --- the wrappers' routing --------------------------------------------------


WRAPPERS = {
    "sha256": lambda x: sha256.sha256(x),
    "expand_message_xmd_sha256":
        lambda x: sha256.expand_message_xmd_sha256(x, DST, 64),
    "shake": lambda x: keccak.shake(x, 64, 168),
    "shake128": lambda x: keccak.shake128(x, 64),
    "shake256": lambda x: keccak.shake256(x, 64),
    "expand_message_xof_shake":
        lambda x: keccak.expand_message_xof_shake(x, DST, 64),
}
BAD_INPUTS = {
    "int32": lambda: torch.zeros((2, 8), dtype=torch.int32),
    "1-D": lambda: torch.zeros(8, dtype=torch.uint8),
    "meta": lambda: torch.zeros((2, 8), dtype=torch.uint8, device="meta"),
}


@pytest.mark.parametrize("bad", list(BAD_INPUTS))
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrappers_raise_on_what_the_kernels_do_not_take(name, bad):
    with pytest.raises(ValueError):
        WRAPPERS[name](BAD_INPUTS[bad]())


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_a_cpu_call_counts_no_launch(name):
    """A CPU tensor takes the plain version (its value is hashlib's) and
    counts nothing; a non-contiguous CPU tensor is taken as it is."""
    m = messages(40)
    x = torch.from_numpy(np.ascontiguousarray(m[:, :32]))
    strided = torch.from_numpy(m)[:, :32]
    assert not strided.is_contiguous()
    LAUNCHES.reset()
    got = WRAPPERS[name](x)
    assert rows(WRAPPERS[name](strided)) == rows(got)
    snap = LAUNCHES.snapshot()
    assert {k: v for k, v in snap.items() if v} == {}
    assert {"sha256", "xmd_sha256", "shake"} <= set(snap)
