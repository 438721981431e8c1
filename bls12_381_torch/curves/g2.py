"""Batched G2: E'(Fp2): y^2 = x^3 + 4(u + 1) (reference src/g2.rs),
counterpart of `bls12_381_tpu/curves/g2.py`: the group law, psi, the GLS
scalar multiplication, Budroni-Pintore cofactor clearing, the psi-based
subgroup check and the byte codecs.

Points are tuples of Fp2 elements (pairs of Fp limb tensors): projective
(x, y, z), affine (x, y, inf_mask).  A plan takes each Fp2 coordinate as
its (c0, c1) rows.  Encodings are numpy uint8 [*batch, 96] (compressed)
or [*batch, 192] (uncompressed), an Fp2 element as c1 then c0
(g2.rs:254-282).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import hostmath as hm
from .. import limbs, params
from ..fields import fp, tower as tw
from . import g1 as _g1
from ..kernels import plan_exec as pe
from ..utils import graphs, profiling
from .weierstrass import FieldFns, Weierstrass

_FNS = FieldFns(
    add=tw.fp2_add,
    neg=tw.fp2_neg,
    mul=tw.fp2_mul,
    mul_many=tw.fp2_mul_many,
    select=tw.fp2_select,
    eq=tw.fp2_eq,
    is_zero=tw.fp2_is_zero,
    zero=tw.fp2_zero,
    one=tw.fp2_one,
    b=lambda batch, device: tw.fp2_const(params.B_G2, batch, device),
    batch_of=lambda x: x[0].shape[1:],
    device_of=lambda x: x[0].device,
    rows=lambda x: [x[0], x[1]],
    from_rows=lambda rows: (rows[0], rows[1]),
    add_plan=pe.g2_add_plan,
    double_plan=pe.g2_double_plan,
    add_mixed_plan=pe.g2_add_mixed_plan,
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


def generator(batch=(), device="cuda"):
    x, y = params.G2_GEN
    return (tw.fp2_const(x, batch, device), tw.fp2_const(y, batch, device),
            tw.fp2_one(batch, device))


def generator_affine(batch=(), device="cuda"):
    """The standard G2 generator, affine (x, y, infinity), broadcast over a
    batch shape."""
    x, y = params.G2_GEN
    return (
        tw.fp2_const(x, batch, device),
        tw.fp2_const(y, batch, device),
        torch.zeros(tuple(batch), dtype=torch.bool, device=device),
    )


def psi_xy(x, y):
    """psi's action on two coordinates, (x, y) -> (c_x x^p, c_y y^p)
    (g2.rs:847-888): the two conjugations are one borrow network, the two
    Fp2 products one fold.  On affine points it is psi itself."""
    batch, dev = x[0].shape[1:], x[0].device
    nx, ny = fp.neg_many([x[1], y[1]])
    cx = tw.fp2_const(hm.PSI_CX, batch, dev)
    cy = tw.fp2_const(hm.PSI_CY, batch, dev)
    px, py = tw.fp2_mul_many([((x[0], nx), cx), ((y[0], ny), cy)])
    return px, py


def psi(p):
    """Untwist-Frobenius-twist (x : y : z) -> (c_x x^p : c_y y^p : z^p);
    it acts as [z] on the subgroup."""
    return psi_xy(p[0], p[1]) + (tw.fp2_conjugate(p[2]),)


def psi2(p):
    return psi(psi(p))


@graphs.releasing
def scalar_mul(p, scalars_mont):
    """[s]P by the 4-way GLS split: psi acts as [z] on the subgroup
    (g2.rs:475-482), so s = c0 + c1|z| + c2|z|^2 + c3|z|^3 (base-|z|
    digits from three Barrett divisions, each c_i < 2^64) gives
    [s]P = [c0]P + [c1](-psi P) + [c2]psi^2 P + [c3](-psi^3 P) (z < 0): four
    64-bit balanced-digit scalars with shared doublings.  Subgroup points
    only; use scalar_mul_generic for any curve point."""
    x = params.BLS_X
    canon = limbs.from_mont(limbs.FR, scalars_mont)
    q3, r3 = limbs.barrett_divmod(canon, x ** 3, 5)
    q2, r2 = limbs.barrett_divmod(r3, x ** 2, 5)
    q1, c0 = limbs.barrett_divmod(r2, x, 5)
    pp = psi(p)
    p3 = psi(pp)                         # [|z|^2]P
    points = [p, CURVE.neg(pp), p3, CURVE.neg(psi(p3))]
    return CURVE.multi_scalar_mul_signed(
        points, [limbs.signed_digits_msb(k, 64) for k in (c0, q1, q2, q3)])


def scalar_mul_generic(p, scalars_mont):
    """[s]P by plain 4-bit windows (any curve point)."""
    return CURVE.scalar_mul_windowed(p, _g1.fr_digits4_msb(scalars_mont))


def mul_by_x(p):
    """[|z|]P (g2.rs semantics; callers handle the sign)."""
    return CURVE.mul_by_const(p, params.BLS_X)


def is_torsion_free(p):
    """psi(P) == [z]P = -[|z|]P (ePrint 2021/1130 §4; g2.rs:475-482)."""
    return CURVE.eq(psi(p), CURVE.neg(mul_by_x(p)))


def clear_cofactor(p):
    """Budroni-Pintore (ia.cr/2017/419; g2.rs:934-947):
    h(P) = [z^2 - z - 1]P + [z - 1]psi(P) + psi^2(2P), with u = |z|:
    [u^2]P + [u]P - P - [u]psi(P) - psi(P) + psi^2(2P), added in that
    order."""
    t1 = mul_by_x(p)              # [u]P
    t2 = mul_by_x(t1)             # [u^2]P
    psip = psi(p)
    t3 = mul_by_x(psip)           # [u]psi(P)
    acc = add(t2, t1)
    acc = add(acc, neg(p))
    acc = add(acc, neg(t3))
    acc = add(acc, neg(psip))
    return add(acc, psi2(double(p)))


def to_affine(p):
    """Projective -> affine, the z inversion amortized over the last batch
    axis (`tw.fp2_batch_inv`, g2.rs:951-984 analog)."""
    return CURVE.to_affine(p, tw.fp2_batch_inv)


batch_normalize = to_affine


# ---------------------------------------------------------------------------
# Serialization (g1.py's split: bytes on the host, the square root and the
# checks on the device)
# ---------------------------------------------------------------------------


def _to_bytes_host(coords, inf) -> np.ndarray:
    """Fp2 coordinates (zero on the identity) -> uint8 [*batch, 96 k], each
    as c1 then c0, from one product launch."""
    batch, dev = inf.shape, inf.device
    zero = tw.fp2_zero(batch, dev)
    rows = [c for x in coords for c in reversed(tw.fp2_select(inf, zero, x))]
    out = fp.to_bytes_host(torch.stack(rows, -1))
    return out.reshape(tuple(batch) + (48 * len(rows),))


def to_compressed_host(aff) -> np.ndarray:
    """Affine batch -> uint8 [*batch, 96]."""
    x, y, inf = aff
    out = _to_bytes_host([x], inf)
    inf_np, large = _g1.masks_host(inf, tw.fp2_lexicographically_largest(y))
    return _g1.set_flags(out, True, inf_np, large & ~inf_np)


def to_uncompressed_host(aff) -> np.ndarray:
    """Affine batch -> uint8 [*batch, 192]: x then y."""
    x, y, inf = aff
    return _g1.set_flags(_to_bytes_host([x, y], inf), False,
                         inf.cpu().numpy(), False)


def _fp2_from_bytes(body: np.ndarray, k: int, device):
    """uint8 [*batch, 96 k] -> (k Fp2 elements, numpy mask: every half
    < p), from one product launch."""
    m, ok = fp.from_bytes_host(body.reshape(body.shape[:-1] + (2 * k, 48)),
                               device)
    return [(m[..., 2 * i + 1], m[..., 2 * i]) for i in range(k)], ok.all(-1)


def _decompress_device(x, inf, sort, check_subgroup: bool):
    """g1._decompress_device over Fp2: y from `tw.fp2_sqrt` of
    x^3 + 4(u + 1) (two Fp2 power launches); graphed as that one is."""
    batch, dev = inf.shape, inf.device
    rhs = tw.fp2_add(tw.fp2_mul(tw.fp2_sqr(x), x),
                     tw.fp2_const(params.B_G2, batch, dev))
    with profiling.span("codec.sqrt"):
        y, on_curve = tw.fp2_sqrt(rhs)
    flip = tw.fp2_lexicographically_largest(y) != sort
    y = tw.fp2_select(flip, tw.fp2_neg(y), y)
    aff = (tw.fp2_select(inf, tw.fp2_zero(batch, dev), x),
           tw.fp2_select(inf, tw.fp2_one(batch, dev), y), inf)
    if check_subgroup:
        with profiling.span("codec.subgroup"):
            tf = is_torsion_free(from_affine(aff))
    else:
        tf = torch.ones(batch, dtype=torch.bool, device=dev)
    return aff, on_curve, tw.fp2_is_zero(x), tf


@profiling.spanned("codec.decode")
@graphs.releasing
def from_compressed_host(data, check_subgroup: bool = True, device="cuda"):
    """uint8 [*batch, 96] -> (affine batch on `device`, numpy valid mask),
    with g1.from_compressed_host's rules over Fp2."""
    data = np.asarray(data, dtype=np.uint8)
    comp, inf, sort = _g1.flags(data)
    (x,), x_ok = _fp2_from_bytes(_g1.bodies(data, 96), 1, device)
    dev = x[0].device
    aff, on_curve, x_zero, tf = graphs.graphed(
        "codec.replay", _decompress_device,
        (x, torch.from_numpy(inf).to(dev), torch.from_numpy(sort).to(dev)),
        check_subgroup)
    on_curve, x_zero, tf = _g1.masks_host(on_curve, x_zero, tf)
    valid = comp & x_ok & (~inf | (x_zero & ~sort)) & (inf | on_curve)
    return aff, valid & (tf | inf)


def _from_uncompressed_device(x, y, inf, check: bool):
    batch, dev = inf.shape, inf.device
    zeros = tw.fp2_is_zero(x) & tw.fp2_is_zero(y)
    aff = (tw.fp2_select(inf, tw.fp2_zero(batch, dev), x),
           tw.fp2_select(inf, tw.fp2_one(batch, dev), y), inf)
    if check:
        proj = from_affine(aff)
        ok = is_on_curve(proj) & (is_torsion_free(proj) | inf)
    else:
        ok = torch.ones(batch, dtype=torch.bool, device=dev)
    return aff, zeros, ok


@graphs.releasing
def from_uncompressed_host(data, check: bool = True, device="cuda"):
    """uint8 [*batch, 192] -> (affine batch on `device`, numpy valid mask),
    with g1.from_uncompressed_host's rules over Fp2."""
    data = np.asarray(data, dtype=np.uint8)
    comp, inf, sort = _g1.flags(data)
    (x, y), ok = _fp2_from_bytes(_g1.bodies(data, 192), 2, device)
    aff, zeros, on = _from_uncompressed_device(
        x, y, torch.from_numpy(inf).to(x[0].device), check)
    zeros, on = _g1.masks_host(zeros, on)
    valid = ~comp & ~sort & ok & (~inf | zeros)
    return aff, valid & on
