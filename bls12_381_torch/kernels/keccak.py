"""Batched Keccak-f[1600], SHAKE-128/256 and expand_message_xof in plain
PyTorch ops.

Counterpart of `bls12_381_tpu/kernels/keccak_jax.py` (plain jnp there, not
a Pallas kernel), the device analog of the reference's ExpandMsgXof path
(expand_msg.rs:167-217).  As in the JAX package each 64-bit Keccak lane is
a (lo, hi) pair of 32-bit halves vectorized over the batch, and a 64-bit
rotation is four shifts and two ors: here each half is an int64 tensor
masked to 32 bits (PyTorch's int64 right shift is arithmetic and an
overflowing left shift is not to be relied on; NOT is `x ^ 0xFFFFFFFF`).

Layout: messages and output uint8 [B, n_bytes]; the state 25 lanes of
([B], [B]).
"""

from __future__ import annotations

import hashlib

import torch

from .sha256 import M32, _const_bytes, as_messages

_RC = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

_ROT = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)


def _rotl64(lane, n: int):
    lo, hi = lane
    n %= 64
    if n == 0:
        return lane
    if n >= 32:
        lo, hi, n = hi, lo, n - 32
        if n == 0:
            return (lo, hi)
    return (((lo << n) & M32) | (hi >> (32 - n)),
            ((hi << n) & M32) | (lo >> (32 - n)))


def _xor(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def _keccak_f(state):
    """24 rounds over state: dict (x, y) -> lane."""
    for rc in _RC:
        # theta
        c = [state[(x, 0)] for x in range(5)]
        for x in range(5):
            for y in range(1, 5):
                c[x] = _xor(c[x], state[(x, y)])
        d = [_xor(c[(x - 1) % 5], _rotl64(c[(x + 1) % 5], 1))
             for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[(x, y)] = _xor(state[(x, y)], d[x])
        # rho and pi
        b = {}
        for x in range(5):
            for y in range(5):
                b[(y, (2 * x + 3 * y) % 5)] = _rotl64(state[(x, y)],
                                                      _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                n1, n2 = b[((x + 1) % 5, y)], b[((x + 2) % 5, y)]
                state[(x, y)] = tuple(b[(x, y)][i] ^ ((n1[i] ^ M32) & n2[i])
                                      for i in range(2))
        # iota
        lo, hi = state[(0, 0)]
        state[(0, 0)] = (lo ^ (rc & M32), hi ^ (rc >> 32))
    return state


def _bytes_to_lanes(block: torch.Tensor):
    """uint8 [B, rate] (little-endian 64-bit lanes) -> list of (lo, hi)."""
    b = block.long()
    halves = (b[:, 0::4] | (b[:, 1::4] << 8) | (b[:, 2::4] << 16)
              | (b[:, 3::4] << 24)).unbind(1)
    return [(halves[2 * i], halves[2 * i + 1])
            for i in range(len(halves) // 2)]


def _lanes_to_bytes(lanes) -> torch.Tensor:
    w = torch.stack([h for lane in lanes for h in lane], 1)
    shifts = torch.tensor((0, 8, 16, 24), device=w.device)
    return ((w.unsqueeze(-1) >> shifts) & 0xFF).reshape(w.shape[0], -1).to(
        torch.uint8)


def shake(data: torch.Tensor, out_len: int, rate: int,
          domain: int = 0x1F) -> torch.Tensor:
    """Batched SHAKE sponge: uint8 [B, msg_len] -> uint8 [B, out_len];
    rate 168 for SHAKE-128, 136 for SHAKE-256."""
    bsz, msg_len = data.shape
    pad = bytearray(rate - msg_len % rate)
    pad[0] = domain
    pad[-1] |= 0x80
    padded = torch.cat([data, _const_bytes(bytes(pad), bsz, data.device)], 1)
    zero = torch.zeros((bsz,), dtype=torch.int64, device=data.device)
    state = {(x, y): (zero, zero) for x in range(5) for y in range(5)}
    order = [(x, y) for y in range(5) for x in range(5)]  # lane index order
    for blk in range(padded.shape[1] // rate):
        lanes = _bytes_to_lanes(padded[:, blk * rate:(blk + 1) * rate])
        for xy, lane in zip(order, lanes):
            state[xy] = _xor(state[xy], lane)
        state = _keccak_f(state)
    out, got = [], 0
    while got < out_len:
        out.append(_lanes_to_bytes([state[xy] for xy in order[:rate // 8]]))
        got += rate
        if got < out_len:
            state = _keccak_f(state)
    return torch.cat(out, 1)[:, :out_len]


def shake128(data: torch.Tensor, out_len: int) -> torch.Tensor:
    return shake(data, out_len, rate=168)


def shake256(data: torch.Tensor, out_len: int) -> torch.Tensor:
    return shake(data, out_len, rate=136)


def expand_message_xof_shake(msgs, dst: bytes, len_in_bytes: int,
                             bits: int = 128, device="cuda") -> torch.Tensor:
    """Batched expand_message_xof (draft-16 §5.3.2): SHAKE(msg ||
    I2OSP(len_in_bytes, 2) || DST || I2OSP(len(DST), 1)), len_in_bytes
    read.  A DST over 255 bytes is first reduced on the host to
    SHAKE(tag || dst, 2k/8), k = bits."""
    if len(dst) > 255:
        h = hashlib.shake_128() if bits == 128 else hashlib.shake_256()
        h.update(b"H2C-OVERSIZE-DST-" + dst)
        dst = h.digest(bits // 4)
    if len_in_bytes > 65535:
        raise ValueError("expand_message_xof bounds exceeded")
    msgs = as_messages(msgs, device)
    suffix = len_in_bytes.to_bytes(2, "big") + dst + bytes([len(dst)])
    full = torch.cat([msgs, _const_bytes(suffix, msgs.shape[0], msgs.device)],
                     1)
    return shake(full, len_in_bytes, rate=168 if bits == 128 else 136)
