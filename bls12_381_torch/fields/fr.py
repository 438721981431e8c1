"""Batched scalar field Fr (255-bit q): 16 16-bit limbs, Montgomery R = 2^256.

Counterpart of `bls12_381_tpu/fields/fr.py` (reference src/scalar.rs), with
the same names: the `limbs` operations bound to the Fr spec, the NTT
constants (generator 7, S = 32, the 2^32-th root of unity), inversion and
powers, the fused NTT butterfly (`kernels/mont.py::butterfly`), the
Tonelli-Shanks square root and the 32-byte little-endian codecs (opposite
endianness from Fp, scalar.rs:256-296); beyond the JAX package, the
32-byte big-endian decoder of the KZG specs (`from_bytes_be`) and sums
of many elements reduced once (`sum_along`, `segment_sum`).  Constructors
take a `device` (the card by default).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .. import limbs, params
from ..kernels import mont
from ..limbs import FR

add = partial(limbs.add, FR)
sub = partial(limbs.sub, FR)
neg = partial(limbs.neg, FR)
mul = partial(limbs.mont_mul, FR)
sqr = partial(limbs.mont_sqr, FR)
select = limbs.select
is_zero = limbs.is_zero
eq = limbs.eq

zero = partial(limbs.zero, FR)
one = partial(limbs.one, FR)
const = partial(limbs.const, FR)
from_ints = partial(limbs.from_ints, FR)
to_ints = partial(limbs.to_ints, FR)

GENERATOR = params.FR_GENERATOR
S = params.FR_S
ROOT_OF_UNITY = params.FR_ROOT_OF_UNITY
# scalar.rs:183-222 (canonical ints; Montgomery-encode with fr.const)
TWO_INV = pow(2, params.Q - 2, params.Q)
ROOT_OF_UNITY_INV = pow(ROOT_OF_UNITY, params.Q - 2, params.Q)
DELTA = pow(GENERATOR, 1 << S, params.Q)  # generator of the order-t group

# the runtime-exponent `pow` below shadows the builtin in this module's
# globals; integer constants after it use `_int_pow`
_int_pow = pow


def inv(a):
    """a^(q-2); 0 maps to 0."""
    return limbs.inv(FR, a)


def pow(a, exp_limbs):  # noqa: A001 -- the JAX package's name
    """a^e with a runtime exponent tensor (`ff::Field::pow`, scalar.rs:
    373-390); exp_limbs are canonical limb rows, e.g. `limbs.from_mont(FR,
    s)` for an Fr-valued exponent."""
    return limbs.pow_runtime(FR, a, exp_limbs)


def pow_fixed(a, e: int):
    return limbs.pow_fixed(FR, a, e)


def batch_inv(a):
    """Product-scan amortized elementwise inverse over the last axis."""
    return limbs.batch_inv(FR, a)


def butterfly(a, b, w):
    """Fused NTT butterfly (a + b w, a - b w) mod q: one kernel launch on a
    CUDA tensor.  The operands are broadcast to a common [16, *batch] and
    flattened to [16, B], as `fr.py:74-88` does."""
    full = (FR.n_limbs,) + tuple(
        torch.broadcast_shapes(a.shape[1:], b.shape[1:], w.shape[1:]))

    def flat(x):
        return x.expand(full).reshape(FR.n_limbs, -1)

    out = mont.butterfly(flat(a), flat(b), flat(w)).reshape((2,) + full)
    return out[0], out[1]


def sqrt(a):
    """Batched Tonelli-Shanks square root (reference Scalar::sqrt,
    scalar.rs:670-681): (root, ok) with ok False for non-residues.

    The JAX package's schedule without its masked (no-op) squarings: after
    w = a^((t-1)/2), x = a w and b = a^t = omega^e lie in the 2^S-order
    subgroup; bit k of the discrete log e is read from acc^(2^(S-1-k)) and
    cleared with omega^(-2^k), and root = x omega^(-e/2), negated whenever
    e != 0 to land on the reference's root (`fr.py:93-171`)."""
    t = (params.Q - 1) >> S
    batch = a.shape[1:]
    dev = a.device
    w = pow_fixed(a, (t - 1) // 2)
    x = mul(a, w)  # a^((t+1)/2)
    acc = mul(x, w)  # a^t
    one_b = one(batch, device=dev)
    half = one_b
    is_qr = any_bit = None
    for k in range(S):
        tk = acc
        for _ in range(S - 1 - k):
            tk = sqr(tk)
        bit = ~eq(tk, one_b)
        acc = select(bit, mul(acc, const(
            _int_pow(ROOT_OF_UNITY_INV, 1 << k, params.Q), batch,
            device=dev)), acc)
        if k == 0:
            is_qr, any_bit = ~bit, bit
        else:
            half = select(bit, mul(half, const(
                _int_pow(ROOT_OF_UNITY_INV, 1 << (k - 1), params.Q), batch,
                device=dev)), half)
            any_bit = any_bit | bit
    root = mul(x, half)
    root = select(any_bit, neg(root), root)
    a_zero = is_zero(a)
    root = select(a_zero, zero(batch, device=dev), root)
    ok = (is_qr & eq(sqr(root), a)) | a_zero
    return root, ok


def _bytes_to_limbs_le(d: torch.Tensor) -> torch.Tensor:
    """uint8 [*batch, 2K] little-endian -> raw [K, *batch] 16-bit limbs."""
    d = d.to(limbs.DTYPE)
    return torch.movedim(d[..., 0::2] | (d[..., 1::2] << 8), -1, 0)


def _as_bytes(data, device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data
    return torch.from_numpy(np.asarray(data, dtype=np.uint8).copy()).to(
        limbs.resolve_device(device))


def from_bytes_wide(data, device="cuda"):
    """uint8 [*batch, 64] little-endian -> Montgomery Fr reduced mod q, on
    the device (scalar.rs:300-331: d0 R^2 + d1 R^3 by two products).  A
    tensor stays on its device; other array-likes go to `device`."""
    d = _as_bytes(data, device)
    return limbs.wide_reduce(FR, _bytes_to_limbs_le(d[..., :32]),
                             _bytes_to_limbs_le(d[..., 32:]))


def from_okm(okm, device="cuda"):
    """48-byte big-endian OKM blocks -> Fr (map_scalar.rs:10-23: zero-pad
    to 64 bytes, reverse to little-endian, wide-reduce)."""
    d = _as_bytes(okm, device).flip(-1)
    pad = torch.zeros(d.shape[:-1] + (16,), dtype=d.dtype, device=d.device)
    return from_bytes_wide(torch.cat([d, pad], dim=-1))


def root_of_unity_pow(k: int) -> int:
    """omega^k as a canonical int (for NTT twiddle constants)."""
    return _int_pow(ROOT_OF_UNITY, k, params.Q)


# ---------------------------------------------------------------------------
# Byte codecs (host side): 32-byte little-endian
# ---------------------------------------------------------------------------


def to_bytes_host(a: torch.Tensor) -> np.ndarray:
    """[16, *batch] Montgomery -> uint8 [*batch, 32] little-endian
    canonical."""
    canon = limbs.from_mont(FR, a).cpu().numpy()
    out = np.zeros(canon.shape[1:] + (32,), dtype=np.uint8)
    out[..., 0::2] = np.moveaxis(canon & 0xFF, 0, -1)
    out[..., 1::2] = np.moveaxis(canon >> 8, 0, -1)
    return out


def from_bytes_host(data, device="cuda"):
    """uint8 [*batch, 32] little-endian -> ([16, *batch] Montgomery on
    `device`, numpy validity mask: the value is < q)."""
    data = np.asarray(data, dtype=np.uint8)
    canon = torch.from_numpy(
        np.moveaxis(data[..., 0::2].astype(np.int32)
                    | (data[..., 1::2].astype(np.int32) << 8), -1, 0).copy())
    c64 = canon.long()
    _, borrow = limbs._sub_limbs(c64, limbs._col(FR.p_limbs, c64),
                                 FR.n_limbs)
    ok = (borrow != 0).numpy()
    return limbs.to_mont(FR, canon.to(limbs.resolve_device(device))), ok


def from_bytes_be(data, device="cuda"):
    """uint8 [*batch, 32] big-endian -> ([16, *batch] Montgomery, validity
    mask: the value is < q), both on the data's device (the KZG specs'
    `bytes_to_bls_field`, KZG_ENDIANNESS = big).  A tensor stays on its
    device and nothing is read back to the host; other array-likes go to
    `device`.  Lanes >= q hold another value, which the caller refuses."""
    d = _as_bytes(data, device)
    if d.shape[-1:] != (32,):
        raise ValueError(f"expected 32-byte field elements, got shape "
                         f"{tuple(d.shape)}")
    canon = _bytes_to_limbs_le(d.flip(-1)).contiguous()
    c64 = canon.long()
    _, borrow = limbs._sub_limbs(c64, limbs._col(FR.p_limbs, c64),
                                 FR.n_limbs)
    return limbs.to_mont(FR, canon), borrow != 0


def _reduce_columns(t: torch.Tensor) -> torch.Tensor:
    """int64 limb columns [16, *batch], each below 2^47, whose value X =
    sum_i t_i 2^(16 i) is a sum of Montgomery elements -> X mod q as Fr
    limbs: the carries resolved into 32 limbs (X < 2^289), then
    `limbs.wide_reduce` (the Montgomery form of X mod q) and `from_mont`."""
    pad = torch.zeros((2 * FR.n_limbs - t.shape[0],) + t.shape[1:],
                      dtype=t.dtype, device=t.device)
    clean = limbs._carry_prop(torch.cat([t, pad]), 2 * FR.n_limbs, 3)
    clean = clean.to(limbs.DTYPE)
    return limbs.from_mont(FR, limbs.wide_reduce(FR, clean[:FR.n_limbs],
                                                 clean[FR.n_limbs:]))


def sum_along(a: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum of an Fr batch [16, *batch] along tensor axis `dim` (>= 1),
    reduced once: the limbs summed in int64 (exact below 2^31 terms),
    then `_reduce_columns`.  Nothing is read back to the host."""
    if dim == 0 or dim == -a.dim():
        raise ValueError("axis 0 is the limb axis")
    return _reduce_columns(a.long().sum(dim))


def segment_sum(a: torch.Tensor, index: torch.Tensor, n: int):
    """[16, n]: column i the sum of the columns k of a [16, K] with
    index[k] == i (int64 [K], each < n), reduced once as `sum_along`."""
    t = torch.zeros((FR.n_limbs, n), dtype=torch.int64, device=a.device)
    return _reduce_columns(t.index_add_(1, index, a.long()))


def from_bytes_wide_host(data, device="cuda"):
    """uint8 [*batch, 64] little-endian -> Montgomery form, reduced mod q
    on the host (scalar.rs:300-331)."""
    data = np.asarray(data, dtype=np.uint8)
    batch = data.shape[:-1]
    flat = data.reshape(-1, 64)
    out = np.empty(flat.shape[0], dtype=object)
    for i, row in enumerate(flat):
        out[i] = int.from_bytes(row.tobytes(), "little") % params.Q
    return from_ints(out.reshape(batch) if batch else out[0], device=device)
