"""Batched SHA-256 and expand_message_xmd: the Hopper kernels of
`csrc/sha256.cu` and their plain PyTorch versions.

Counterpart of `bls12_381_tpu/kernels/sha256_jax.py` (plain jnp there, not
a Pallas kernel, fused by XLA into the jitted hash-to-curve graph): one
compression schedule over a batch of equal-length messages, so that
hash_to_curve's message expansion (expand_msg.rs:230-328, draft-16
§5.3.1) runs on the device beside the field arithmetic.  Layouts as in
the JAX package: messages and output uint8 [B, n_bytes].

`sha256` and `expand_message_xmd_sha256` launch `sha256_kernel` and
`xmd_sha256_kernel` on a CUDA tensor (one thread per message, the whole
expansion in registers; the source's note says what bounds them) and count
one launch each in `LAUNCHES.sha256` / `LAUNCHES.xmd_sha256`; on a CPU
tensor they run `sha256_plain` / `expand_message_xmd_sha256_plain` and
count nothing.  A uint8 tensor that is not 2-D, another dtype, another
device, or a non-contiguous CUDA tensor raises ValueError; a failed build
or launch raises, and nothing falls back.

`xmd_params` packs what the XMD kernel takes by value, everything that is
the same for every lane of a call, as big-endian words: the state after
the Z_pad block (the plain compression of 64 zero bytes), b0's input after
the message (I2OSP(len_in_bytes, 2) || 0 || DST' || padding, laid out from
the message's last whole word, the message's bytes in it zero), b_i's
input after its first 32 bytes (I2OSP(i, 1) || DST' || padding, the byte of
i zero), the terms of b_i's first block that depend only on those words,
and the widths of the kernel's message loads and output stores
(`io_width`: 16, 4 or 1 bytes, from the tensors' addresses and row
lengths; the kernel instance follows the load width).  DST' is DST ||
I2OSP(len(DST), 1) after the host's reduction of an oversize DST; its 256
bytes at most put b0's words at XMD_B0_TAIL_WORDS and b_i's at
XMD_BI_TAIL_WORDS, 756 bytes of parameters in all (the cap is stated in
the .cu too).  `xmd_ell` holds draft-16's bounds for both paths.

The plain versions: PyTorch on the CPU has no add, shift or compare for
uint32, so a word is an int64 tensor holding a value below 2^32, masked
with 0xFFFFFFFF after every add and left shift (a left shift by < 32 of
such a value cannot overflow int64); NOT is `x ^ 0xFFFFFFFF`.  A
compression is about 4000 elementwise launches on the card, which is why
the card takes the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import struct

import numpy as np
import torch

from .. import limbs
from . import LAUNCHES, build
from .mont import check_launch, device_kind

M32 = 0xFFFFFFFF

_K = (
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
)

_H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

# csrc/sha256.cu's XmdParams (756 bytes): midstate; msg_len, len_in_bytes,
# ell, len(DST'), b0's and b_i's blocks, the load and store widths; b0's
# and b_i's parameter words (zero-padded to these caps: at most 332 and 288
# bytes), b_i's first block's K + W of rounds 8-15 and its 9 schedule terms
XMD_B0_TAIL_WORDS = 84
XMD_BI_TAIL_WORDS = 72
_XMD_PARAMS = struct.Struct(
    f"<16I{XMD_B0_TAIL_WORDS}I{XMD_BI_TAIL_WORDS}I8I9I")

_P = ctypes.c_void_p
_SIGNATURES = {
    # (msg, out, msg_len, B, stream)
    "bls_sha256": (_P, _P, ctypes.c_int, ctypes.c_int, _P),
    # (msg, out, params [host XmdParams], B, stream)
    "bls_expand_xmd_sha256": (_P, _P, _P, ctypes.c_int, _P),
}


def _lib():
    return build.load("sha256", _SIGNATURES)


def byte_rows_device(x: torch.Tensor, name: str) -> str:
    """'cpu' (plain version) or 'cuda' (kernel) for messages uint8
    [B, n]; raises ValueError for another dtype, shape or device, and for
    a CUDA tensor that is not contiguous."""
    if x.dtype != torch.uint8 or x.dim() != 2:
        raise ValueError(f"{name}: expected uint8 [B, n], got "
                         f"{tuple(x.shape)} {x.dtype}")
    if device_kind(x) == "cuda" and not x.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous tensor")
    return x.device.type


# ---------------------------------------------------------------------------
# Plain versions (int64 words)
# ---------------------------------------------------------------------------


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & M32


def _compress(state, block_words):
    """One SHA-256 compression: state 8 x [B], block 16 x [B] int64
    words."""
    w = list(block_words)
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ M32) & g)
        t1 = h + s1 + ch + _K[i] + w[i]  # < 5 * 2^32: no int64 overflow
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & M32, c, b, a,
                                  (t1 + s0 + maj) & M32)
    return [(s + v) & M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def _pad_suffix(msg_len: int) -> bytes:
    """SHA-256 padding of a message of msg_len bytes: 0x80, zeros, and the
    bit length (big-endian, 8 bytes), to a multiple of 64 bytes."""
    return (b"\x80" + bytes((55 - msg_len) % 64)
            + (8 * msg_len).to_bytes(8, "big"))


def _bytes_to_words(data: torch.Tensor):
    """uint8 [B, 4k] big-endian -> k int64 words of [B]."""
    b = data.long()
    words = ((b[:, 0::4] << 24) | (b[:, 1::4] << 16) | (b[:, 2::4] << 8)
             | b[:, 3::4])
    return list(words.unbind(1))


def _words_to_bytes(words) -> torch.Tensor:
    """k int64 words of [B] -> uint8 [B, 4k] big-endian."""
    w = torch.stack(words, 1)
    shifts = torch.tensor((24, 16, 8, 0), device=w.device)
    return ((w.unsqueeze(-1) >> shifts) & 0xFF).reshape(w.shape[0], -1).to(
        torch.uint8)


def _const_bytes(bs: bytes, batch: int, device) -> torch.Tensor:
    """bytes broadcast to uint8 [batch, len(bs)]."""
    row = torch.from_numpy(np.frombuffer(bs, dtype=np.uint8).copy())
    return row.to(device).expand(batch, len(bs))


def _digest(data: torch.Tensor) -> torch.Tensor:
    """The plain SHA-256 of each row, on the tensor's own device."""
    bsz, msg_len = data.shape
    padded = torch.cat([data, _const_bytes(_pad_suffix(msg_len), bsz,
                                           data.device)], 1)
    state = [torch.full((bsz,), h, dtype=torch.int64, device=data.device)
             for h in _H0]
    for blk in range(padded.shape[1] // 64):
        state = _compress(state, _bytes_to_words(
            padded[:, 64 * blk:64 * (blk + 1)]))
    return _words_to_bytes(state)


# The plain version of `sha256`.  The plain XMD calls `_digest`, so that
# counting the calls of `sha256_plain` never counts the XMD's digests.
sha256_plain = _digest


def as_messages(msgs, device) -> torch.Tensor:
    """Messages as uint8 [B, n]: a tensor stays where it lies; an array or
    an equal-length list of bytes goes to `device`."""
    if isinstance(msgs, torch.Tensor):
        return msgs
    if not hasattr(msgs, "shape"):
        if len({len(m) for m in msgs}) != 1:
            raise ValueError("device expansion needs equal-length messages")
        msgs = np.frombuffer(b"".join(msgs), dtype=np.uint8).reshape(
            len(msgs), -1)
    return torch.from_numpy(np.array(msgs, dtype=np.uint8)).to(
        limbs.resolve_device(device))


def reduce_dst(dst: bytes) -> bytes:
    """The DST expand_message_xmd uses: a DST over 255 bytes is replaced by
    SHA-256("H2C-OVERSIZE-DST-" || DST) (draft-16 §5.3.3,
    expand_msg.rs:19-105)."""
    if len(dst) > 255:
        return hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    return dst


def xmd_ell(len_in_bytes: int) -> int:
    """ceil(len_in_bytes / 32); raises ValueError where draft-16 does
    (ell > 255, len_in_bytes > 65535) and for a negative length."""
    ell = -(-len_in_bytes // 32)
    if ell > 255 or len_in_bytes > 65535:
        raise ValueError("expand_message_xmd bounds exceeded")
    if len_in_bytes < 0:
        raise ValueError(f"expand_message_xmd: len_in_bytes {len_in_bytes}")
    return ell


def expand_message_xmd_sha256_plain(msgs, dst: bytes, len_in_bytes: int,
                                    device="cuda") -> torch.Tensor:
    """The plain version of `expand_message_xmd_sha256`, on the messages'
    own device (a tensor) or `device`."""
    dst = reduce_dst(dst)
    ell = xmd_ell(len_in_bytes)
    msgs = as_messages(msgs, device)
    bsz, dev = msgs.shape[0], msgs.device
    dst_prime = _const_bytes(dst + bytes([len(dst)]), bsz, dev)
    b0 = _digest(torch.cat([_const_bytes(bytes(64), bsz, dev), msgs,
                            _const_bytes(len_in_bytes.to_bytes(2, "big")
                                         + b"\x00", bsz, dev), dst_prime], 1))
    out = [_digest(torch.cat([b0, _const_bytes(b"\x01", bsz, dev),
                              dst_prime], 1))]
    for i in range(2, ell + 1):
        out.append(_digest(torch.cat([b0 ^ out[-1],
                                      _const_bytes(bytes([i]), bsz, dev),
                                      dst_prime], 1)))
    return torch.cat(out, 1)[:, :len_in_bytes]


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def zpad_midstate() -> tuple:
    """The SHA-256 state after b0's first block, Z_pad = 64 zero bytes:
    the plain compression of H0 with a zero block, 8 ints."""
    zero = torch.zeros(1, dtype=torch.int64)
    state = [torch.full((1,), h, dtype=torch.int64) for h in _H0]
    return tuple(int(w) for w in _compress(state, [zero] * 16))


def _be_words(data: bytes) -> list:
    return list(struct.unpack(f">{len(data) // 4}I", data))


def _sigma0(x: int) -> int:
    return (((x >> 7) | (x << 25)) ^ ((x >> 18) | (x << 14)) ^ (x >> 3)) & M32


def _sigma1(x: int) -> int:
    return (((x >> 17) | (x << 15)) ^ ((x >> 19) | (x << 13))
            ^ (x >> 10)) & M32


def io_width(ptr: int, row_bytes: int) -> int:
    """The widest access, 16, 4 or 1 bytes, at which every row of a uint8
    [B, row_bytes] tensor at address ptr starts aligned: the width divides
    both."""
    return next(w for w in (16, 4, 1) if ptr % w == 0 and row_bytes % w == 0)


@functools.lru_cache(maxsize=256)
def xmd_params(dst: bytes, len_in_bytes: int, msg_len: int, load: int = 1,
               store: int = 1) -> bytes:
    """csrc/sha256.cu's XmdParams for one call, packed (see the module
    note): the Z_pad midstate, msg_len, len_in_bytes, ell, len(DST'),
    b0's blocks after Z_pad and b_i's blocks, the message load and output
    store widths (`io_width`), b0's and b_i's parameter words, and b_i's
    first block's K[t] + W[t], t = 8..15, and schedule terms W16 -
    sigma0(W1) - W0, W17 - sigma0(W2) - W1 and sigma0(W[u-15]) + W[u-16],
    u = 24..30 (W[8] without i).  The DST is reduced first; `xmd_ell`
    raises on the bounds.  Cached: a call's parameters depend on these
    arguments alone."""
    ell = xmd_ell(len_in_bytes)
    dst = reduce_dst(dst)
    dst_prime = dst + bytes([len(dst)])
    b0_in = 64 + msg_len + 3 + len(dst_prime)  # Z_pad || msg || .. || DST'
    b0_pad = _pad_suffix(b0_in)
    b0_tail = _be_words(bytes(msg_len % 4) + len_in_bytes.to_bytes(2, "big")
                        + b"\0" + dst_prime + b0_pad)
    bi = bytes(33) + dst_prime + _pad_suffix(33 + len(dst_prime))
    bi_tail = _be_words(bi[32:])
    assert len(b0_tail) <= XMD_B0_TAIL_WORDS
    assert len(bi_tail) <= XMD_BI_TAIL_WORDS
    w = _be_words(bi[:64])
    kw = [(_K[t] + w[t]) & M32 for t in range(8, 16)]
    sched = [(_sigma1(w[14]) + w[9]) & M32, (_sigma1(w[15]) + w[10]) & M32]
    sched += [(_sigma0(w[u - 15]) + w[u - 16]) & M32 for u in range(24, 31)]
    return _XMD_PARAMS.pack(
        *zpad_midstate(), msg_len, len_in_bytes, ell, len(dst_prime),
        (b0_in + len(b0_pad)) // 64 - 1, len(bi) // 64, load, store,
        *b0_tail, *[0] * (XMD_B0_TAIL_WORDS - len(b0_tail)),
        *bi_tail, *[0] * (XMD_BI_TAIL_WORDS - len(bi_tail)), *kw, *sched)


def sha256(data: torch.Tensor) -> torch.Tensor:
    """Batched SHA-256: uint8 [B, msg_len] -> uint8 [B, 32] (every message
    of the batch has the same length); one `sha256_kernel` launch on a
    CUDA tensor."""
    if byte_rows_device(data, "sha256") == "cpu":
        return sha256_plain(data)
    bsz, msg_len = data.shape
    out = torch.empty((bsz, 32), dtype=torch.uint8, device=data.device)
    if bsz == 0:
        return out
    with torch.cuda.device(data.device):
        rc = _lib().bls_sha256(data.data_ptr(), out.data_ptr(), msg_len, bsz,
                               torch.cuda.current_stream().cuda_stream)
        LAUNCHES.sha256 += 1
    check_launch(rc, "sha256")
    return out


def expand_message_xmd_sha256(msgs, dst: bytes, len_in_bytes: int,
                              device="cuda") -> torch.Tensor:
    """Batched expand_message_xmd with SHA-256 (draft-16 §5.3.1):
    messages [B, msg_len] uint8 (see `as_messages`) -> uint8
    [B, len_in_bytes].  A DST over 255 bytes is first reduced on the host
    (§5.3.3, expand_msg.rs:19-105).  One `xmd_sha256_kernel` launch on a
    CUDA tensor: the instance whose message loads are `io_width` of the
    rows (16 bytes for 16-byte aligned rows of a multiple of 16 bytes)."""
    msgs = as_messages(msgs, device)
    kind = byte_rows_device(msgs, "expand_message_xmd_sha256")
    if kind == "cpu":
        return expand_message_xmd_sha256_plain(msgs, dst, len_in_bytes)
    bsz, msg_len = msgs.shape
    xmd_ell(len_in_bytes)
    out = torch.empty((bsz, len_in_bytes), dtype=torch.uint8,
                      device=msgs.device)
    if bsz == 0 or len_in_bytes == 0:
        return out
    params = xmd_params(bytes(dst), len_in_bytes, msg_len,
                        io_width(msgs.data_ptr(), msg_len),
                        io_width(out.data_ptr(), len_in_bytes))
    with torch.cuda.device(msgs.device):
        rc = _lib().bls_expand_xmd_sha256(
            msgs.data_ptr(), out.data_ptr(), params, bsz,
            torch.cuda.current_stream().cuda_stream)
        LAUNCHES.xmd_sha256 += 1
    check_launch(rc, "expand_message_xmd_sha256")
    return out
