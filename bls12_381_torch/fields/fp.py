"""Batched base field Fp (381-bit): 24 16-bit limbs, Montgomery R = 2^384.

Counterpart of `bls12_381_tpu/fields/fp.py`: the `limbs` operations bound
to the Fp spec, the inversion, powers, the square root and signs, the
hash_to_field reduction `from_okm`, and the 48-byte big-endian codecs
(fp.rs:179-227).  Constructors take a `device` (the card by default).

The runtime-exponent `pow` below keeps the JAX package's name, so in this
module's globals it shadows the builtin: nothing here calls the builtin
`pow` (the JAX package's `fr.sqrt` once broke on exactly that, aa17796).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .. import limbs, params
from ..limbs import FP

add = partial(limbs.add, FP)
sub = partial(limbs.sub, FP)
neg = partial(limbs.neg, FP)
mul = partial(limbs.mont_mul, FP)
sqr = partial(limbs.mont_sqr, FP)
sop = partial(limbs.sum_of_products, FP)
sop_fold = partial(limbs.sop_fold, FP)
mul_many = partial(limbs.mul_many, FP)
add_many = partial(limbs.add_many, FP)
sub_many = partial(limbs.sub_many, FP)
neg_many = partial(limbs.neg_many, FP)
select = limbs.select
is_zero = limbs.is_zero
eq = limbs.eq
sgn0 = limbs.sgn0

zero = partial(limbs.zero, FP)
one = partial(limbs.one, FP)
const = partial(limbs.const, FP)
from_ints = partial(limbs.from_ints, FP)
to_ints = partial(limbs.to_ints, FP)


def inv(a):
    """a^(p-2); 0 maps to 0 (fp.rs:346 returns a CtOption; callers mask)."""
    return limbs.inv(FP, a)


def pow(a, exp_limbs):  # noqa: A001 -- the JAX package's name
    """a^e with a runtime exponent tensor (`ff::Field::pow`; see
    `limbs.pow_runtime`).  For a public exponent use `pow_fixed`: one
    kernel launch."""
    return limbs.pow_runtime(FP, a, exp_limbs)


def pow_fixed(a, e: int):
    return limbs.pow_fixed(FP, a, e)


def batch_inv(a):
    """Elementwise inverse amortized over the last batch axis (one `inv`
    for the whole axis, g1.rs:806-839); zeros invert to zero."""
    return limbs.batch_inv(FP, a)


def sqrt(a):
    """(root, ok): the candidate a^((p+1)/4), one `pow_fixed` launch, and
    the mask root^2 == a (fp.rs:324-343)."""
    cand = limbs.pow_fixed(FP, a, (params.P + 1) // 4)
    return cand, limbs.eq(limbs.mont_sqr(FP, cand), a)


def lexicographically_largest(a):
    """a > (p-1)/2 on the canonical value (fp.rs:273-297)."""
    return limbs.gt_half(FP, limbs.from_mont(FP, a))


def sgn0_mont(a):
    """Parity of the canonical value of a Montgomery-form element."""
    return limbs.sgn0(limbs.from_mont(FP, a))


def _as_bytes(data, device) -> torch.Tensor:
    """A uint8 tensor stays where it lies; other array-likes go to
    `device`."""
    if isinstance(data, torch.Tensor):
        return data
    return torch.from_numpy(np.asarray(data, dtype=np.uint8).copy()).to(
        limbs.resolve_device(device))


def from_okm(okm, device="cuda"):
    """hash_to_field's element from 64 big-endian OKM bytes
    (map_g1.rs:506-532): uint8 [*batch, 64] -> [24, *batch] Montgomery.
    The 512-bit value hi 2^384 + lo (raw limbs) reduces as
    lo R^2 R^-1 + hi R^3 R^-1 (`limbs.wide_reduce`: one fold), the value
    of the JAX package's mont_mul(lo, R^2) + mont_mul(mont_mul(hi, R^2),
    M(2^384))."""
    d = _as_bytes(okm, device).flip(-1).to(limbs.DTYPE)  # little-endian
    raw = torch.movedim(d[..., 0::2] | (d[..., 1::2] << 8), -1, 0)  # [32, *]
    hi = torch.cat([raw[FP.n_limbs:],
                    raw.new_zeros((2 * FP.n_limbs - 32,) + raw.shape[1:])])
    return limbs.wide_reduce(FP, raw[:FP.n_limbs], hi)


# ---------------------------------------------------------------------------
# Byte codecs (host side): 48-byte big-endian
# ---------------------------------------------------------------------------


def to_bytes_host(a: torch.Tensor) -> np.ndarray:
    """[24, *batch] Montgomery -> uint8 [*batch, 48] big-endian canonical
    (one product on the device, then the host)."""
    canon = np.moveaxis(limbs.from_mont(FP, a).cpu().numpy(), 0, -1)
    out = np.empty(canon.shape[:-1] + (48,), dtype=np.uint8)
    out[..., 1::2] = (canon & 0xFF)[..., ::-1]
    out[..., 0::2] = (canon >> 8)[..., ::-1]
    return out


def from_bytes_host(data, device="cuda"):
    """uint8 [*batch, 48] big-endian -> ([24, *batch] Montgomery on
    `device`, numpy validity mask: the value is < p)."""
    data = np.asarray(data, dtype=np.uint8)
    be = data[..., 1::2].astype(np.int32) | (data[..., 0::2].astype(np.int32)
                                             << 8)
    canon = torch.from_numpy(np.moveaxis(be[..., ::-1], -1, 0).copy())
    c64 = canon.long()
    _, borrow = limbs._sub_limbs(c64, limbs._col(FP.p_limbs, c64),
                                 FP.n_limbs)
    ok = (borrow != 0).numpy()
    return limbs.to_mont(FP, canon.to(limbs.resolve_device(device))), ok
