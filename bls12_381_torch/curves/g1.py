"""Batched G1: E(Fp): y^2 = x^3 + 4 (reference src/g1.rs), counterpart of
`bls12_381_tpu/curves/g1.py`: the group law, the GLV scalar
multiplication, the subgroup check, cofactor clearing and the byte codecs.

Points are tuples of Fp limb tensors [24, *batch]: projective (x, y, z),
affine (x, y, inf_mask).  Scalars are Montgomery Fr limb tensors
[16, *batch].  Encodings are numpy uint8 [*batch, 48] (compressed) or
[*batch, 96] (uncompressed), parsed on the host with the square root,
curve and subgroup checks on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import hostmath as hm
from .. import limbs, params
from ..fields import fp
from ..kernels import plan_exec as pe
from ..utils import graphs, profiling
from .weierstrass import FieldFns, Weierstrass

_FNS = FieldFns(
    add=fp.add,
    neg=fp.neg,
    mul=fp.mul,
    mul_many=fp.mul_many,
    select=fp.select,
    eq=fp.eq,
    is_zero=fp.is_zero,
    zero=lambda batch, device: fp.zero(batch, device=device),
    one=lambda batch, device: fp.one(batch, device=device),
    b=lambda batch, device: fp.const(params.B_G1, batch, device=device),
    batch_of=lambda x: x.shape[1:],
    device_of=lambda x: x.device,
    rows=lambda x: [x],
    from_rows=lambda rows: rows[0],
    add_plan=pe.g1_add_plan,
    double_plan=pe.g1_double_plan,
    add_mixed_plan=pe.g1_add_mixed_plan,
)

CURVE = Weierstrass(_FNS)

identity = CURVE.identity
from_affine = CURVE.from_affine
is_identity = CURVE.is_identity
is_on_curve = CURVE.is_on_curve
eq = CURVE.eq
neg = CURVE.neg
double = CURVE.double
add = CURVE.add
add_mixed = CURVE.add_mixed

# endomorphism constant: cube root of unity with phi(P) = -[z^2]P (g1.rs:421)
BETA = hm.G1_BETA


def generator(batch=(), device="cuda"):
    gx, gy = params.G1_GEN
    return (fp.const(gx, batch, device=device),
            fp.const(gy, batch, device=device), fp.one(batch, device=device))


def generator_affine(batch=(), device="cuda"):
    gx, gy = params.G1_GEN
    return (fp.const(gx, batch, device=device),
            fp.const(gy, batch, device=device),
            torch.zeros(tuple(batch), dtype=torch.bool, device=device))


def _phi_x(p):
    """beta x: the endomorphism phi(x : y : z) = (beta x : y : z)."""
    return fp.mul(fp.const(BETA, p[0].shape[1:], device=p[0].device), p[0])


@graphs.releasing
def scalar_mul(p, scalars_mont):
    """[s]P by the GLV split: phi acts as [-z^2] on the subgroup
    (g1.rs:401-410), so s = k1 + k2 z^2 with k1, k2 < 2^128 gives
    [s]P = [k1]P + [k2](beta x : -y : z), two 128-bit balanced-digit
    scalars with shared doublings.  Subgroup points only; use
    scalar_mul_generic for any curve point."""
    canon = limbs.from_mont(limbs.FR, scalars_mont)
    k2, k1 = limbs.barrett_divmod(canon, params.BLS_X ** 2, 9)
    p2 = (_phi_x(p), fp.neg(p[1]), p[2])  # [z^2]P = -phi(P)
    return CURVE.multi_scalar_mul_signed(
        [p, p2], [limbs.signed_digits_msb(k1, 128),
                  limbs.signed_digits_msb(k2, 128)])


def scalar_mul_generic(p, scalars_mont):
    """[s]P by plain 4-bit windows over the canonical s < q (g1.rs:754-774
    semantics; any curve point)."""
    return CURVE.scalar_mul_windowed(p, fr_digits4_msb(scalars_mont))


def fr_bits_msb(scalars_mont):
    """Montgomery Fr [16, *batch] -> [255, *batch] bool bits, MSB first."""
    canon = limbs.from_mont(limbs.FR, scalars_mont).long()
    return torch.stack([((canon[j // 16] >> (j % 16)) & 1) != 0
                        for j in range(254, -1, -1)])


def fr_digits4_msb(scalars_mont):
    """Montgomery Fr [16, *batch] -> [64, *batch] int32 4-bit digits, MSB
    first."""
    return limbs.digits4_msb(limbs.from_mont(limbs.FR, scalars_mont), 256)


def mul_by_x(p):
    """[|z|]P by the static bits of |z| (g1.rs:777-795; callers handle the
    sign)."""
    return CURVE.mul_by_const(p, params.BLS_X)


def clear_cofactor(p):
    """[1 - z]P = [1 + |z|]P (ia.cr/2019/403; g1.rs:800-802)."""
    return CURVE.mul_by_const(p, params.H_EFF_G1)


def is_torsion_free(p):
    """phi(P) == -[z^2]P (ePrint 2021/1130 §6; g1.rs:401-410)."""
    zsq = mul_by_x(mul_by_x(p))
    return CURVE.eq((_phi_x(p), p[1], p[2]), CURVE.neg(zsq))


def to_affine(p):
    """Projective -> affine, the z inversion amortized over the last batch
    axis (`fp.batch_inv`; the reference's batch_normalize, g1.rs:806-839)."""
    return CURVE.to_affine(p, fp.batch_inv)


batch_normalize = to_affine


# ---------------------------------------------------------------------------
# Serialization (notes/serialization.rs): bytes on the host, the square
# root and the checks on the device, the validity mask back on the host
# ---------------------------------------------------------------------------


def flags(data: np.ndarray):
    """(compression, infinity, sort) bits of encodings uint8 [*batch, n],
    as numpy bool arrays."""
    top = data[..., 0]
    return ((top >> 7) & 1).astype(bool), ((top >> 6) & 1).astype(bool), \
        ((top >> 5) & 1).astype(bool)


def set_flags(out: np.ndarray, compression: bool, inf, sort) -> np.ndarray:
    """out with the flag bits of its first byte set, in place."""
    out[..., 0] |= np.where(inf, 0b0100_0000, 0).astype(np.uint8) | \
        np.where(sort, 0b0010_0000, 0).astype(np.uint8) | \
        np.uint8(0b1000_0000 if compression else 0)
    return out


def bodies(data: np.ndarray, n: int) -> np.ndarray:
    """Encodings of n bytes each, copied with the flag bits cleared;
    ValueError for another width."""
    if data.ndim < 1 or data.shape[-1] != n:
        raise ValueError(f"expected encodings of {n} bytes, got an array "
                         f"of shape {data.shape}")
    body = np.array(data, dtype=np.uint8)
    body[..., 0] &= 0b0001_1111
    return body


def masks_host(*masks) -> list:
    """Device bool masks as numpy arrays, in one host sync."""
    return list(torch.stack(masks).cpu().numpy())


def to_compressed_host(aff) -> np.ndarray:
    """Affine batch -> uint8 [*batch, 48]."""
    x, y, inf = aff
    batch, dev = x.shape[1:], x.device
    out = fp.to_bytes_host(fp.select(inf, fp.zero(batch, device=dev), x))
    inf_np, large = masks_host(inf, fp.lexicographically_largest(y))
    return set_flags(out, True, inf_np, large & ~inf_np)


def to_uncompressed_host(aff) -> np.ndarray:
    """Affine batch -> uint8 [*batch, 96]: x then y, one product launch."""
    x, y, inf = aff
    batch, dev = x.shape[1:], x.device
    zero = fp.zero(batch, device=dev)
    xy = torch.stack([fp.select(inf, zero, x), fp.select(inf, zero, y)], -1)
    out = fp.to_bytes_host(xy).reshape(tuple(batch) + (96,))
    return set_flags(out, False, inf.cpu().numpy(), False)


def _decompress_device(x, inf, sort, check_subgroup: bool):
    """The device half of decompression: y from the square root of
    x^3 + 4, its sign from `sort`, the identity masked, and the subgroup
    check (all lanes true when off).  Returns (affine, on_curve, x == 0,
    torsion_free).  Nothing is read back to the host: on the card a CUDA
    graph per (batch, check_subgroup) replays it from the second call on
    (`utils/graphs.py`; the span `codec.replay`)."""
    batch, dev = x.shape[1:], x.device
    rhs = fp.add(fp.mul(fp.sqr(x), x), fp.const(params.B_G1, batch,
                                                device=dev))
    with profiling.span("codec.sqrt"):
        y, on_curve = fp.sqrt(rhs)
    flip = fp.lexicographically_largest(y) != sort
    y = fp.select(flip, fp.neg(y), y)
    aff = (fp.select(inf, fp.zero(batch, device=dev), x),
           fp.select(inf, fp.one(batch, device=dev), y), inf)
    if check_subgroup:
        with profiling.span("codec.subgroup"):
            tf = is_torsion_free(from_affine(aff))
    else:
        tf = torch.ones(batch, dtype=torch.bool, device=dev)
    return aff, on_curve, fp.is_zero(x), tf


@profiling.spanned("codec.decode")
@graphs.releasing
def from_compressed_host(data, check_subgroup: bool = True, device="cuda"):
    """uint8 [*batch, 48] -> (affine batch on `device`, numpy valid mask).
    An invalid encoding is masked rather than raised (the batched CtOption
    of g1.rs:326-390): a clear compression bit, x >= p, an infinity with
    x != 0 or the sort bit, an x off the curve, and with the check a point
    outside G1."""
    data = np.asarray(data, dtype=np.uint8)
    comp, inf, sort = flags(data)
    x, x_ok = fp.from_bytes_host(bodies(data, 48), device)
    aff, on_curve, x_zero, tf = graphs.graphed(
        "codec.replay", _decompress_device,
        (x, torch.from_numpy(inf).to(x.device),
         torch.from_numpy(sort).to(x.device)), check_subgroup)
    on_curve, x_zero, tf = masks_host(on_curve, x_zero, tf)
    valid = comp & x_ok & (~inf | (x_zero & ~sort)) & (inf | on_curve)
    return aff, valid & (tf | inf)


def _from_uncompressed_device(x, y, inf, check: bool):
    """(affine, x == y == 0, on the curve and in G1 or the identity)."""
    batch, dev = x.shape[1:], x.device
    zeros = fp.is_zero(x) & fp.is_zero(y)
    aff = (fp.select(inf, fp.zero(batch, device=dev), x),
           fp.select(inf, fp.one(batch, device=dev), y), inf)
    if check:
        proj = from_affine(aff)
        ok = is_on_curve(proj) & (is_torsion_free(proj) | inf)
    else:
        ok = torch.ones(batch, dtype=torch.bool, device=dev)
    return aff, zeros, ok


@graphs.releasing
def from_uncompressed_host(data, check: bool = True, device="cuda"):
    """uint8 [*batch, 96] -> (affine batch on `device`, numpy valid mask):
    invalid are a set compression or sort bit, a coordinate >= p, an
    infinity that is not all zeros, and with the check a point off the
    curve or outside G1."""
    data = np.asarray(data, dtype=np.uint8)
    comp, inf, sort = flags(data)
    xy, ok = fp.from_bytes_host(
        bodies(data, 96).reshape(data.shape[:-1] + (2, 48)), device)
    aff, zeros, on = _from_uncompressed_device(
        xy[..., 0], xy[..., 1], torch.from_numpy(inf).to(xy.device), check)
    zeros, on = masks_host(zeros, on)
    valid = ~comp & ~sort & ok.all(-1) & (~inf | zeros)
    return aff, valid & on
