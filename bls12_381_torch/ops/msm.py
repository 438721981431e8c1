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
    Steps 3-5 are `segment_sums`, which `ops/aggregate.py` shares to sum
    validator keys by index.  On a card they are instead, for every window
    at once (one span `msm.buckets`), a fold (`_fold_sums`): the windows'
    sorted lanes back to back, each bucket's points added into it with one
    mixed addition a lane by the plan kernel's fold mode
    (`kernels/plan_exec.py` `plan_fold`), a handful of launches a call.
    The fold adds in another order than the scan, so on a card the
    projective sums differ from the CPU's; the affine points are equal.
  per window, span `msm.window_sum`:
    6. sum_b b * B_b as a suffix scan and a halving tree
    7. recombine: result = sum_w 2^(c w) S_w, c doublings and one add
  Each public MSM is the span `msm` (`utils/profiling.py`).

On a card the launch sequence of steps 0-7 is fixed by the group, N, c and
the endomorphism split: nothing in it reads data back to the host.  So
`msm_g1` and `msm_g2` run it from a CUDA graph per shape
(`utils/graphs.py`): the first call at a shape runs eagerly, the second
captures and replays, and every later call replays, its span
`msm.replay` holding the stage spans.  A replay is one launch of host work
where the eager call dispatches some 6,000 (N = 4096, c = 12).  Up to four
shapes keep their graphs, whose pools hold at most an eighth of the
card's memory.  CPU tensors run the steps as written.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from .. import limbs, params
from ..curves import g1 as G1
from ..curves import g2 as G2
from ..fields import fp, tower as tw
from ..kernels import BUCKETS
from ..kernels import plan_exec as pe
from ..limbs import FR
from ..utils import graphs, profiling, scans

MSM_WINDOW = 12  # bits per window: the JAX package's config.msm_window
# The fold's run lengths (`fold_levels`): a level of K lanes gives each
# folder M = K / FOLD_FOLDERS lanes (a power of two, clamped to FOLD_RUNS),
# so a wide level fills the card's ~34,000 resident folders (132 SMs, four
# 64-lane tiles each) twice over or more, and a narrow one is FOLD_RUNS[0]
# steps deep; every level leaves 2 K / M lanes (two partials a run), until
# at most FOLD_LAST lanes go to one folder.
FOLD_FOLDERS = 1 << 14
FOLD_RUNS = (8, 64)
FOLD_LAST = 16


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


def _on_card(t: torch.Tensor) -> bool:
    """Whether the bucket sums of t's device fold (a card) or scan (the
    CPU, the JAX package's order of additions)."""
    return t.device.type == "cuda"


def fold_levels(K: int) -> list[tuple[int, int]]:
    """(lanes, run length M) of each level of a fold over K lanes: static
    in K, so a card's call captures into a graph."""
    levels = []
    while K > FOLD_LAST:
        M = min(max(1 << max((K // FOLD_FOLDERS).bit_length() - 1, 0),
                    FOLD_RUNS[0]), FOLD_RUNS[1])
        levels.append((K, M))
        K = 2 * -(-K // M)
    return levels + [(K, K)]


@functools.lru_cache(maxsize=None)
def _identity_mask(curve) -> int:
    """Bits of the identity's Fp rows that hold 1 (the rest hold 0)."""
    rows = [r for c in curve.identity((1,), "cpu") for r in curve.f.rows(c)]
    one = limbs.const(limbs.FP, 1, (1,), device="cpu")
    mask = 0
    for k, r in enumerate(rows):
        if bool((r == one).all()):
            mask |= 1 << k
        elif bool(r.any()):
            raise ValueError("the identity's rows must be 0 or 1")
    return mask


def _fold_sums(curve_mod, table, order, dest, n_out, negs=None):
    """Sums of the runs of equal dest over K lanes by the plan kernel's
    fold mode (`plan_exec.plan_fold`; its plain version on CPU tensors):
    lane i adds the affine point table[order[i]] (`plan_exec.pack_words`
    of the x then y rows), y negated where negs[i], by the curve's mixed
    addition; the partials of each level by its full addition, until one
    run holds every lane (`fold_levels`).  Output j < n_out holds the sum
    of the lanes with dest j, the identity where none has it.  Returns
    (projective points [n_out], the levels run)."""
    curve = curve_mod.CURVE
    f = curve.f
    width = len(f.rows(curve.identity((1,), "cpu")[0]))
    ident = [r for cd in curve.identity((n_out,), dest.device)
             for r in f.rows(cd)]
    totals = torch.stack(ident).contiguous()
    fold = pe.Fold(table, dest, order, negs,
                   (0, 0) if negs is None else (width, 2 * width),
                   one_mask=_identity_mask(curve))
    levels = fold_levels(dest.shape[0])
    for n, (_, M) in enumerate(levels):
        plan = pe.compile_plan(f.add_mixed_plan() if n == 0
                               else f.add_plan(), fold=True)
        fold = pe.plan_fold(plan, fold, M, totals)
    rows = totals.unbind(0)
    return tuple(f.from_rows(rows[k:k + width])
                 for k in range(0, len(rows), width)), len(levels)


def segment_sums(curve_mod, aff_xy, order, dest, n_out: int, negs=None,
                 stage: str | None = None, packed=None):
    """Sums of segments of gathered affine points, the one bucket
    accumulation of the MSM and of `ops/aggregate.py`'s key sums: lane i
    (of K) takes the affine point order[i] of aff_xy (the affine (x, y),
    lanes last), y negated where negs[i] is true; the segments are the
    runs of equal dest[i] (int64 [K], non-decreasing), and output j < n_out
    is the sum of the segment with dest j, the identity where there is
    none (a segment with dest outside [0, n_out) is summed and dropped).
    Returns projective points [n_out].

    On a card, one fold over every lane (`_fold_sums`) from `packed`, the
    table as `plan_exec.pack_words` gives it, or a packing of aff_xy; on
    the CPU the segmented inclusive scan of the group law, the JAX
    package's order of additions: the gathered points lifted to z = 1,
    heads where dest changes, each total at its segment's tail.  With a
    `stage`, preparing the operands is the span `<stage>.gather` and the
    sums the span `<stage>.sum`.  `kernels.BUCKETS` counts the calls of
    each kind, the lanes folded and the fold's levels."""
    curve = curve_mod.CURVE
    f = curve.f
    dev = order.device
    if _on_card(order):
        with _stage_span(stage, "gather"):
            if packed is None:
                packed = pe.pack_words([r for c in aff_xy for r in f.rows(c)])
        with _stage_span(stage, "sum"):
            sums, n_levels = _fold_sums(curve_mod, packed, order.long(),
                                        dest, n_out, negs)
        BUCKETS.fold += 1
        BUCKETS.lanes += order.shape[0]
        BUCKETS.levels += n_levels
        return sums
    BUCKETS.scan += 1
    with _stage_span(stage, "gather"):
        x, y = scans.tree_map(lambda t: t.index_select(-1, order), aff_xy)
        if negs is not None:
            y = scans.tree_map(lambda n_, y_: torch.where(negs, n_, y_),
                               f.neg(y), y)
        pts = (x, y, f.one(order.shape, dev))
    with _stage_span(stage, "sum"):
        heads = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           dest[1:] != dest[:-1]])[None]
        ids = torch.arange(n_out, dtype=dest.dtype, device=dev)
        pos_r = torch.searchsorted(dest, ids, right=True)
        pos_l = torch.searchsorted(dest, ids, right=False)
        scanned = _segmented_scan_add(curve, pts, heads)
        return scans.tree_map(
            lambda v, i: torch.where(pos_r > pos_l, v, i),
            scans.tree_map(lambda t: t.index_select(
                -1, (pos_r - 1).clamp(min=0)), scanned),
            curve.identity((n_out,), dev))


def _stage_span(stage: str | None, part: str):
    return contextlib.nullcontext() if stage is None else \
        profiling.span(f"{stage}.{part}")


def _window_buckets(curve_mod, aff_xy, order, mags_s, negs_s, c: int):
    """One window's bucket totals B_1 .. B_half from its sorted digits:
    aff_xy holds the affine (x, y) with the lanes last; order, mags_s,
    negs_s are [B].  Returns projective points [half].  The sign of a
    balanced digit costs one y negation; bucket b is output b - 1, so
    bucket 0 (zero digits, identity inputs) is dropped."""
    return segment_sums(curve_mod, aff_xy, order, mags_s.long() - 1,
                        1 << (c - 1), negs_s)


def _window_lanes(sorted_digits, c: int):
    """Every window's sorted lanes back to back, as a fold takes them:
    (order, dest, negs) [W B'] and the outputs' count.  Bucket b of window
    w is output w (half + 1) + b, so no segment crosses a window."""
    order, mags_s, negs_s = sorted_digits
    n_win, span = order.shape[0], (1 << (c - 1)) + 1
    dest = mags_s.long() + span * torch.arange(
        n_win, device=order.device)[:, None]
    return (order.reshape(-1), dest.reshape(-1), negs_s.reshape(-1),
            n_win * span)


def _all_window_buckets(curve_mod, aff_xy, sorted_digits, c: int):
    """Every window's bucket totals from one `segment_sums` over the
    windows' sorted lanes (`_window_lanes`; a card's path), bucket 0's
    outputs dropped.  Returns per window the projective points B_1 ..
    B_half."""
    n_win, span = sorted_digits[0].shape[0], (1 << (c - 1)) + 1
    order, dest, negs, n_out = _window_lanes(sorted_digits, c)
    sums = segment_sums(curve_mod, aff_xy, order, dest, n_out, negs)
    return [scans.tree_map(lambda t: t.view(t.shape[0], n_win, span)[:, w, 1:],
                           sums) for w in range(n_win)]


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
    window's buckets (on a card every window's at once, first), then their
    sum, c doublings and one add."""
    curve = curve_mod.CURVE
    order, mags_s, negs_s = sorted_digits
    acc = curve.identity((), order.device)
    folded = None
    if _on_card(order):
        with profiling.span("msm.buckets"):
            folded = _all_window_buckets(curve_mod, aff_xy, sorted_digits, c)
    for w in reversed(range(order.shape[0])):
        if folded is not None:
            buckets = folded[w]
        else:
            with profiling.span("msm.buckets"):
                buckets = _window_buckets(curve_mod, aff_xy, order[w],
                                          mags_s[w], negs_s[w], c)
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
    return graphs.graphed("msm.replay", _msm_g1, (points_proj, scalars_mont),
                          c, glv)


def _msm_g1(points_proj, scalars_mont, c: int, glv: bool):
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
    return graphs.graphed("msm.replay", _msm_g2, (points_proj, scalars_mont),
                          c, gls)


def _msm_g2(points_proj, scalars_mont, c: int, gls: bool):
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
