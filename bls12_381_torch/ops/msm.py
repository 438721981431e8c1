"""Batched Pippenger multi-scalar multiplication over G1 and G2.

Counterpart of `bls12_381_tpu/ops/msm.py`, step by step, so that with the
same order of additions the projective result equals the JAX package's limb
for limb.  Bucket accumulation is a sort and a segmented scan, with no
scatter:

  once (span `msm.recode`):
    0. split the scalars with the curve endomorphism (GLV 2-way on G1, GLS
       4-way on G2): 2x / 4x the lanes, 1/2 / 1/4 the windows
    1. signed c-bit digits: 2^(c-1) buckets
    2. ONE stable argsort of every window's digit magnitudes [W, B]
  per window (MSB first), span `msm.buckets`:
    3. gather the affine (x, y) by the window's order, negate y where the
       digit is negative, lift to projective with z = 1
    4. segmented inclusive scan of the group law along the lanes
       (`utils/scans.py`): each group add is one `plan_exec` launch
    5. bucket totals at the segment tails, found by searchsorted; empty
       buckets take the identity; bucket 0 (zero digits, identity inputs)
       is never read
  per window, span `msm.window_sum`:
    6. sum_b b * B_b as a suffix scan and a halving tree
    7. recombine: result = sum_w 2^(c w) S_w, c doublings and one add
  Each public MSM is the span `msm` (`utils/profiling.py`).
"""

from __future__ import annotations

import torch

from .. import limbs, params
from ..curves import g1 as G1
from ..curves import g2 as G2
from ..fields import fp, tower as tw
from ..limbs import FR
from ..utils import profiling, scans

MSM_WINDOW = 12  # bits per window: the JAX package's config.msm_window


def _segmented_scan_add(curve, pts, heads):
    """Inclusive segmented scan of the group law along the last axis; heads
    bool [1, B] marks where a segment starts."""

    def combine(left, right):
        (lp, lh), (rp, rh) = left, right
        summed = curve.add(lp, rp)
        return (scans.tree_map(lambda s, r: torch.where(rh, r, s), summed, rp),
                lh | rh)

    dev = heads.device
    ident1 = (curve.identity((1,), dev),
              torch.zeros((1, 1), dtype=torch.bool, device=dev))
    out, _ = scans.inclusive_scan(combine, (pts, heads), ident1)
    return out


def _window_buckets(curve_mod, aff_xy, order, mags_s, negs_s, c: int):
    """One window's bucket totals B_1 .. B_half from its sorted digits:
    aff_xy holds the affine (x, y) with the lanes last; order, mags_s,
    negs_s are [B].  Returns projective points [half]."""
    curve = curve_mod.CURVE
    f = curve.f
    half = 1 << (c - 1)
    dev = order.device

    x, y = scans.tree_map(lambda t: t.index_select(-1, order), aff_xy)
    # the sign of a balanced digit costs one y negation
    y = scans.tree_map(lambda n_, y_: torch.where(negs_s, n_, y_),
                       f.neg(y), y)
    pts = (x, y, f.one(order.shape, dev))
    heads = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       mags_s[1:] != mags_s[:-1]])[None]
    scanned = _segmented_scan_add(curve, pts, heads)

    # bucket b's total sits at the tail of its segment
    bucket_ids = torch.arange(1, half + 1, dtype=mags_s.dtype, device=dev)
    pos_r = torch.searchsorted(mags_s, bucket_ids, right=True)
    pos_l = torch.searchsorted(mags_s, bucket_ids, right=False)
    tail = (pos_r - 1).clamp(min=0)
    return scans.tree_map(
        lambda v, i: torch.where(pos_r > pos_l, v, i),
        scans.tree_map(lambda t: t.index_select(-1, tail), scanned),
        curve.identity((half,), dev))


def _bucket_sum(curve, buckets, dev):
    """sum_b b B_b = the sum of the suffix sums B_half, B_half + B_(half-1),
    ...; a projective point with an empty batch shape."""
    ident1 = curve.identity((1,), dev)
    suffix = scans.suffix_scan(curve.add, buckets, ident1)
    total = scans.tree_reduce(curve.add, suffix, ident1)
    return scans.tree_map(lambda t: t[..., 0], total)


def _sort_digits(mags, negs):
    """The one stable sort of every window's digit magnitudes [W, B]:
    (order, sorted magnitudes, their signs)."""
    order = torch.argsort(mags, dim=-1, stable=True)
    return (order, torch.take_along_dim(mags, order, dim=-1),
            torch.take_along_dim(negs, order, dim=-1))


def _msm_windows(curve_mod, aff_xy, sorted_digits, c: int):
    """The window loop over sorted signed digits [W, B], MSB first: each
    window's buckets, then their sum, c doublings and one add."""
    curve = curve_mod.CURVE
    order, mags_s, negs_s = sorted_digits
    acc = curve.identity((), order.device)
    for w in reversed(range(order.shape[0])):
        with profiling.span("msm.buckets"):
            buckets = _window_buckets(curve_mod, aff_xy, order[w], mags_s[w],
                                      negs_s[w], c)
        with profiling.span("msm.window_sum"):
            total = _bucket_sum(curve, buckets, order.device)
            for _ in range(c):
                acc = curve.double(acc)
            acc = curve.add(acc, total)
    return acc


@profiling.spanned("msm")
def msm_g1(points_proj, scalars_mont, c: int = MSM_WINDOW, glv: bool = True):
    """sum_i [s_i] P_i over G1 for projective points (x, y, z) [24, B] and
    Montgomery Fr scalars [16, B]; the projective sum, batch shape ().

    glv=True splits each scalar with the GLV endomorphism: s = k1 + k2 z^2
    with [z^2]P = -phi(P) = (beta x, -y), so twice the lanes run half the
    windows (128-bit halves).  Valid for subgroup points; glv=False runs the
    plain 255-bit digits for any curve point."""
    with profiling.span("msm.recode"):
        aff, mags, negs = _recode_g1(points_proj, scalars_mont, c, glv)
        digits = _sort_digits(mags, negs)
    return _msm_windows(G1, aff, digits, c)


def _recode_g1(points_proj, scalars_mont, c: int, glv: bool):
    """msm_g1's affine points and signed digits [W, B'] (B' = 2B with
    GLV)."""
    canon = limbs.from_mont(FR, scalars_mont)
    # normalize once: the window gathers move two coordinates and the scans
    # start from z = 1; identity lanes get digit 0 (bucket 0, never read)
    ax, ay, inf = G1.to_affine(points_proj)
    if not glv:
        mags, negs = limbs.signed_digits_lsb(canon, 255, c)
        return (ax, ay), mags.masked_fill(inf[None], 0), negs
    k2, k1 = limbs.barrett_divmod(canon, params.BLS_X ** 2, 9)
    beta = fp.const(G1.BETA, ax.shape[1:], device=ax.device)
    aff = tuple(torch.cat([a, b], dim=-1)
                for a, b in zip((ax, ay), (fp.mul(beta, ax), fp.neg(ay))))
    m1, n1 = limbs.signed_digits_lsb(k1, 128, c)
    m2, n2 = limbs.signed_digits_lsb(k2, 128, c)
    mags = torch.cat([m1, m2], dim=-1).masked_fill(
        torch.cat([inf, inf])[None], 0)
    return aff, mags, torch.cat([n1, n2], dim=-1)


@profiling.spanned("msm")
def msm_g1_large(points_proj, scalars_mont, c: int = MSM_WINDOW,
                 glv: bool = True, chunk_log2: int = 21):
    """msm_g1 over chunks of 2^chunk_log2 points, folded with single group
    additions, for batches whose scan working set would not fit at once."""
    B = scalars_mont.shape[-1]
    cs = 1 << chunk_log2
    if B <= cs:
        return msm_g1(points_proj, scalars_mont, c=c, glv=glv)
    acc = None
    for i in range(0, B, cs):
        part = msm_g1(tuple(t[..., i:i + cs] for t in points_proj),
                      scalars_mont[..., i:i + cs], c=c, glv=glv)
        acc = part if acc is None else G1.add(acc, part)
    return acc


def _gls_points(ax, ay):
    """P, [|z|]P = -psi(P), [|z|^2]P = psi^2(P), [|z|^3]P = -psi^3(P) of
    affine (x, y), concatenated along the lanes; the psi images die on
    return, before the window loop."""
    pp = G2.psi_xy(ax, ay)
    p3 = G2.psi_xy(*pp)
    p4 = G2.psi_xy(*p3)
    return scans.tree_map(lambda *ts: torch.cat(ts, dim=-1), (ax, ay),
                          (pp[0], tw.fp2_neg(pp[1])), p3,
                          (p4[0], tw.fp2_neg(p4[1])))


@profiling.spanned("msm")
def msm_g2(points_proj, scalars_mont, c: int = MSM_WINDOW, gls: bool = True):
    """sum_i [s_i] P_i over G2 (points: tuples of Fp2 coordinates).

    gls=True splits each scalar in base |z| (s = c0 + c1|z| + c2|z|^2 +
    c3|z|^3, each c_i < 2^64): psi acts as [z] on the subgroup, so the four
    64-bit digits run against P, -psi(P), psi^2(P), -psi^3(P), a quarter
    of the windows.  Subgroup points only; gls=False runs the plain 255-bit
    digits."""
    with profiling.span("msm.recode"):
        aff, mags, negs = _recode_g2(points_proj, scalars_mont, c, gls)
        digits = _sort_digits(mags, negs)
    return _msm_windows(G2, aff, digits, c)


def _recode_g2(points_proj, scalars_mont, c: int, gls: bool):
    """msm_g2's affine points and signed digits [W, B'] (B' = 4B with
    GLS)."""
    canon = limbs.from_mont(FR, scalars_mont)
    ax, ay, inf = G2.to_affine(points_proj)  # as in msm_g1
    if not gls:
        mags, negs = limbs.signed_digits_lsb(canon, 255, c)
        return (ax, ay), mags.masked_fill(inf[None], 0), negs
    x = params.BLS_X
    q3, r3 = limbs.barrett_divmod(canon, x ** 3, 5)
    q2, r2 = limbs.barrett_divmod(r3, x ** 2, 5)
    q1, c0 = limbs.barrett_divmod(r2, x, 5)

    aff = _gls_points(ax, ay)
    parts = [limbs.signed_digits_lsb(k, 64, c) for k in (c0, q1, q2, q3)]
    mags = torch.cat([m for m, _ in parts], dim=-1).masked_fill(
        torch.cat([inf] * 4)[None], 0)
    return aff, mags, torch.cat([n for _, n in parts], dim=-1)
