"""Batched Keccak-f[1600], SHAKE-128/256 and expand_message_xof: the
Hopper kernel of `csrc/keccak.cu` and its plain PyTorch version.

Counterpart of `bls12_381_tpu/kernels/keccak_jax.py` (plain jnp there, not
a Pallas kernel), the device analog of the reference's ExpandMsgXof path
(expand_msg.rs:167-217).  Layout: messages and output uint8 [B, n_bytes].

`shake` (and `shake128`, `shake256`, `expand_message_xof_shake`) launch
`shake_kernel` on a CUDA tensor, one thread per message with the 25 lanes
as native 64-bit words in registers, and count one launch in
`LAUNCHES.shake`; the XOF passes I2OSP(len_in_bytes, 2) || DST ||
I2OSP(len(DST), 1) to the kernel as a suffix it absorbs after the message
(nothing is concatenated on the device).  On a CPU tensor they run
`shake_plain` / `expand_message_xof_shake_plain` and count nothing.  The
ValueErrors are `sha256.byte_rows_device`'s; nothing falls back.

The plain version: as in the JAX package each 64-bit Keccak lane is a
(lo, hi) pair of 32-bit halves vectorized over the batch, and a 64-bit
rotation is four shifts and two ors: here each half is an int64 tensor
masked to 32 bits (PyTorch's int64 right shift is arithmetic and an
overflowing left shift is not to be relied on; NOT is `x ^ 0xFFFFFFFF`);
the state is 25 lanes of ([B], [B]).
"""

from __future__ import annotations

import ctypes
import hashlib
import struct

import torch

from . import LAUNCHES, build
from .mont import check_launch
from .sha256 import M32, _const_bytes, as_messages, byte_rows_device

MAX_RATE = 168     # bytes (SHAKE-128); csrc/keccak.cu's kMaxLanes = 21

# csrc/keccak.cu's ShakeParams: msg_len, out_len, rate, domain,
# suffix_len, suffix (zero-padded to 260)
_SHAKE_PARAMS = struct.Struct("<5I260s")
_SIGNATURES = {
    # (msg, out, params [host ShakeParams], B, stream)
    "bls_shake": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_void_p),
}


def _lib():
    return build.load("keccak", _SIGNATURES)

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


def shake_plain(data: torch.Tensor, out_len: int, rate: int,
                domain: int = 0x1F) -> torch.Tensor:
    """The plain version of `shake`, on the tensor's own device."""
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


def _check_sponge(out_len: int, rate: int, domain: int) -> None:
    if out_len < 1 or rate % 8 or not 8 <= rate <= MAX_RATE \
            or not 0 <= domain <= 0xFF:
        raise ValueError(f"shake: out_len {out_len}, rate {rate}, domain "
                         f"{domain}; expected out_len >= 1, a rate of 8 to "
                         f"{MAX_RATE} bytes in steps of 8, a domain byte")


def _shake_launch(data: torch.Tensor, out_len: int, rate: int, domain: int,
                  suffix: bytes) -> torch.Tensor:
    """One `shake_kernel` launch: the sponge over each row of the CUDA
    tensor data followed by `suffix` (at most 258 bytes: the XOF's)."""
    bsz, msg_len = data.shape
    out = torch.empty((bsz, out_len), dtype=torch.uint8, device=data.device)
    if bsz == 0:
        return out
    packed = _SHAKE_PARAMS.pack(msg_len, out_len, rate, domain, len(suffix),
                                suffix)
    with torch.cuda.device(data.device):
        rc = _lib().bls_shake(data.data_ptr(), out.data_ptr(), packed, bsz,
                              torch.cuda.current_stream().cuda_stream)
        LAUNCHES.shake += 1
    check_launch(rc, "shake")
    return out


def shake(data: torch.Tensor, out_len: int, rate: int,
          domain: int = 0x1F) -> torch.Tensor:
    """Batched SHAKE sponge: uint8 [B, msg_len] -> uint8 [B, out_len];
    rate 168 for SHAKE-128, 136 for SHAKE-256.  One `shake_kernel` launch
    on a CUDA tensor."""
    _check_sponge(out_len, rate, domain)
    if byte_rows_device(data, "shake") == "cpu":
        return shake_plain(data, out_len, rate, domain)
    return _shake_launch(data, out_len, rate, domain, b"")


def shake128(data: torch.Tensor, out_len: int) -> torch.Tensor:
    return shake(data, out_len, rate=168)


def shake256(data: torch.Tensor, out_len: int) -> torch.Tensor:
    return shake(data, out_len, rate=136)


def _xof_dst(dst: bytes, bits: int) -> bytes:
    """A DST over 255 bytes reduced on the host to SHAKE(tag || dst, 2k/8),
    k = bits."""
    if len(dst) > 255:
        h = hashlib.shake_128() if bits == 128 else hashlib.shake_256()
        h.update(b"H2C-OVERSIZE-DST-" + dst)
        dst = h.digest(bits // 4)
    return dst


def expand_message_xof_shake_plain(msgs, dst: bytes, len_in_bytes: int,
                                   bits: int = 128,
                                   device="cuda") -> torch.Tensor:
    """The plain version of `expand_message_xof_shake`: `shake_plain` of
    the messages with the suffix concatenated, on the messages' own device
    (a tensor) or `device`."""
    dst = _xof_dst(dst, bits)
    if len_in_bytes > 65535:
        raise ValueError("expand_message_xof bounds exceeded")
    msgs = as_messages(msgs, device)
    suffix = len_in_bytes.to_bytes(2, "big") + dst + bytes([len(dst)])
    full = torch.cat([msgs, _const_bytes(suffix, msgs.shape[0], msgs.device)],
                     1)
    return shake_plain(full, len_in_bytes, rate=168 if bits == 128 else 136)


def expand_message_xof_shake(msgs, dst: bytes, len_in_bytes: int,
                             bits: int = 128, device="cuda") -> torch.Tensor:
    """Batched expand_message_xof (draft-16 §5.3.2): SHAKE(msg ||
    I2OSP(len_in_bytes, 2) || DST || I2OSP(len(DST), 1)), len_in_bytes
    read.  A DST over 255 bytes is first reduced on the host to
    SHAKE(tag || dst, 2k/8), k = bits.  One `shake_kernel` launch on a
    CUDA tensor, the suffix absorbed after each message."""
    if len_in_bytes > 65535:
        raise ValueError("expand_message_xof bounds exceeded")
    rate = 168 if bits == 128 else 136
    _check_sponge(len_in_bytes, rate, 0x1F)
    msgs = as_messages(msgs, device)
    if byte_rows_device(msgs, "expand_message_xof_shake") == "cpu":
        return expand_message_xof_shake_plain(msgs, dst, len_in_bytes, bits)
    dst = _xof_dst(dst, bits)
    return _shake_launch(msgs, len_in_bytes, rate, 0x1F,
                         len_in_bytes.to_bytes(2, "big") + dst
                         + bytes([len(dst)]))
