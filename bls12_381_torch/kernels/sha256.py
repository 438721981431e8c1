"""Batched SHA-256 and expand_message_xmd in plain PyTorch ops.

Counterpart of `bls12_381_tpu/kernels/sha256_jax.py` (plain jnp there, not
a Pallas kernel): one compression schedule vectorized over a batch of
equal-length messages, so that hash_to_curve's message expansion
(expand_msg.rs:230-328, draft-16 §5.3.1) runs on the device beside the
field arithmetic.  Layouts as in the JAX package: messages and output
uint8 [B, n_bytes], the hash state 8 words of [B].

PyTorch on the CPU has no add, shift or compare for uint32, so a word is
an int64 tensor holding a value below 2^32, masked with 0xFFFFFFFF after
every add and left shift (a left shift by < 32 of such a value cannot
overflow int64); NOT is `x ^ 0xFFFFFFFF`.  A compression is about 4000
elementwise launches on the card.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import limbs

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


def sha256(data: torch.Tensor) -> torch.Tensor:
    """Batched SHA-256: uint8 [B, msg_len] -> uint8 [B, 32] (every message
    of the batch has the same length)."""
    bsz, msg_len = data.shape
    padded = torch.cat([data, _const_bytes(_pad_suffix(msg_len), bsz,
                                           data.device)], 1)
    state = [torch.full((bsz,), h, dtype=torch.int64, device=data.device)
             for h in _H0]
    for blk in range(padded.shape[1] // 64):
        state = _compress(state, _bytes_to_words(
            padded[:, 64 * blk:64 * (blk + 1)]))
    return _words_to_bytes(state)


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


def expand_message_xmd_sha256(msgs, dst: bytes, len_in_bytes: int,
                              device="cuda") -> torch.Tensor:
    """Batched expand_message_xmd with SHA-256 (draft-16 §5.3.1):
    messages [B, msg_len] uint8 (see `as_messages`) -> uint8
    [B, len_in_bytes].  A DST over 255 bytes is first reduced on the host
    (§5.3.3, expand_msg.rs:19-105)."""
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = -(-len_in_bytes // 32)
    if ell > 255 or len_in_bytes > 65535:
        raise ValueError("expand_message_xmd bounds exceeded")
    msgs = as_messages(msgs, device)
    bsz, dev = msgs.shape[0], msgs.device
    dst_prime = _const_bytes(dst + bytes([len(dst)]), bsz, dev)
    b0 = sha256(torch.cat([_const_bytes(bytes(64), bsz, dev), msgs,
                           _const_bytes(len_in_bytes.to_bytes(2, "big")
                                        + b"\x00", bsz, dev), dst_prime], 1))
    out = [sha256(torch.cat([b0, _const_bytes(b"\x01", bsz, dev),
                             dst_prime], 1))]
    for i in range(2, ell + 1):
        out.append(sha256(torch.cat([b0 ^ out[-1],
                                     _const_bytes(bytes([i]), bsz, dev),
                                     dst_prime], 1)))
    return torch.cat(out, 1)[:, :len_in_bytes]
