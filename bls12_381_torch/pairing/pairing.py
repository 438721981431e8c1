"""Batched optimal-ate pairing (reference src/pairings.rs), the port's main
path.  Counterpart of `bls12_381_tpu/pairing/pairing.py`:

  * Lines use the D-twist "045" sparse shape: the line through points of
    E'(Fp2), evaluated at P = (xp, yp) in G1, is
    (a yp) + b (v w) + (c xp) (v^2 w) with Fp2 coefficients (a, b, c)
    independent of P, projective and scaled by Fp2 factors (killed by the
    final exponentiation).
  * `prepare_g2` computes the 68 coefficient triples (63 doubling and 5
    addition steps for BLS_X = 0xd201000000010000), one fused plan per step
    that computes the line and the point update together.  The schedule is
    static, so each step runs only the branch it needs.
  * `miller_loop_batched` scales and identity-masks all 68 lines in one
    fold, then runs static segments of fused f^2 * line doubling steps with
    single line multiplies at the five addition steps.
  * `final_exponentiation`: easy part (p^6-1)(p^2+1), then the hard part
    with cofactor 3 via 3 (p^4-p^2+1)/q = l0 + l1 p + l2 p^2 + l3 p^3,
    l3 = (z-1)^2, l2 = z l3, l1 = z l2 - l3, l0 = z l1 + 3, computed with
    five exponentiations by |z| (cyclotomic inverse = conjugate).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import params
from ..curves import g2 as G2
from ..fields import fp, tower as tw
from ..kernels import plan_exec as pe
from ..utils import profiling

# ---------------------------------------------------------------------------
# Static schedules from the bits of BLS_X below the MSB
# ---------------------------------------------------------------------------

_X_BITS = [int(b) for b in bin(params.BLS_X)[3:]]  # 63 bits
N_DOUBLING_STEPS = len(_X_BITS)  # 63
N_COEFFS = N_DOUBLING_STEPS + sum(_X_BITS)  # 68 (pairings.rs:539)

# for each of the 68 line applications: is f squared first (doubling step)?
_SQR_FLAGS = []
_IS_ADD_STEP = []
for _bit in _X_BITS:
    _SQR_FLAGS.append(True)
    _IS_ADD_STEP.append(False)
    if _bit:
        _SQR_FLAGS.append(False)
        _IS_ADD_STEP.append(True)
assert len(_SQR_FLAGS) == N_COEFFS

# maximal runs of doubling steps broken by single addition steps:
# (start, length, is_sqr_run)
_SEGMENTS = []
_i = 0
while _i < N_COEFFS:
    _j = _i
    while _j < N_COEFFS and _SQR_FLAGS[_j]:
        _j += 1
    if _j > _i:
        _SEGMENTS.append((_i, _j - _i, True))
    if _j < N_COEFFS:
        _SEGMENTS.append((_j, 1, False))
        _j += 1
    _i = _j
assert sum(s[1] for s in _SEGMENTS) == N_COEFFS

# run-length schedule of |z|: (squarings, then multiply by f?) segments
_X_RUNS = []
_run = 0
for _bit in _X_BITS:
    _run += 1
    if _bit:
        _X_RUNS.append((_run, True))
        _run = 0
if _run:
    _X_RUNS.append((_run, False))


# ---------------------------------------------------------------------------
# G2 preparation (== G2Prepared, pairings.rs:498-546)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class G2Prepared:
    """68 line-coefficient triples: coeffs has shape
    [68, 3 (a, b, c), 2 (c0, c1), L, *batch] (the JAX package's layout).
    `infinity` [*batch] masks identity inputs: their lines become no-ops
    (pairings.rs:563-586)."""

    coeffs: torch.Tensor
    infinity: torch.Tensor


def prepare_g2(q_aff) -> G2Prepared:
    """The 68 line-coefficient triples of an affine G2 batch
    (xq, yq, infinity).  Identity inputs are replaced by the generator
    while computing and masked when the lines are applied (the reference's
    conditional-select dance, pairings.rs:611-614)."""
    xq, yq, inf = q_aff
    batch, dev = xq[0].shape[1:], xq[0].device
    gen = G2.generator_affine(batch, dev)
    xq = tw.fp2_select(inf, gen[0], xq)
    yq = tw.fp2_select(inf, gen[1], yq)
    # T = (X, Y, Z) = (xq, yq, 1), as the plans' six input rows
    t = [xq[0], xq[1], yq[0], yq[1], fp.one(batch, device=dev),
         fp.zero(batch, device=dev)]
    coeffs = []
    for is_add in _IS_ADD_STEP:
        if is_add:
            out = pe.run_plan(pe.g2_add_step_plan(),
                              t + [xq[0], xq[1], yq[0], yq[1]])
        else:
            out = pe.run_plan(pe.g2_dbl_step_plan(), t)
        coeffs.append(torch.stack(out[:6]).reshape((3, 2) + out[0].shape))
        t = out[6:]
    return G2Prepared(coeffs=torch.stack(coeffs), infinity=inf)


# ---------------------------------------------------------------------------
# Miller loop
# ---------------------------------------------------------------------------


def miller_loop_batched(p_aff, prep: G2Prepared):
    """f_{|z|,Q}(P), conjugated for z < 0, for batches of affine G1 points
    (xp, yp, infinity) and prepared G2 coefficients.

    All 68 lines are scaled by the G1 point and identity-masked in ONE fold
    up front (ell(), pairings.rs:696-707); then static segments of fused
    f^2 * line doubling steps run with single line multiplies between.
    Identity terms contribute f *= 1 (pairings.rs:563-586)."""
    xp, yp, inf_p = p_aff
    batch, dev = xp.shape[1:], xp.device
    either_inf = inf_p | prep.infinity

    def comp(i, j):  # [68, 3, 2, L, *batch] -> [L, 68, *batch]
        return prep.coeffs[:, i, j].movedim(1, 0)

    a0, a1 = comp(0, 0), comp(0, 1)
    b0, b1 = comp(1, 0), comp(1, 1)
    c0, c1 = comp(2, 0), comp(2, 1)
    ypb = yp.unsqueeze(1).expand(a0.shape)
    xpb = xp.unsqueeze(1).expand(a0.shape)
    s0, s1, s2, s3 = fp.mul_many([(a0, ypb), (a1, ypb), (c0, xpb),
                                  (c1, xpb)])
    sbatch = (N_COEFFS,) + tuple(batch)
    mask = either_inf.unsqueeze(0).expand(sbatch)
    g0 = tw.fp2_select(mask, tw.fp2_one(sbatch, dev), (s0, s1))
    g4 = tw.fp2_select(mask, tw.fp2_zero(sbatch, dev), (b0, b1))
    g5 = tw.fp2_select(mask, tw.fp2_zero(sbatch, dev), (s2, s3))
    # [68, 6, L, *batch]
    lines = torch.stack([x.movedim(1, 0) for x in (g0[0], g0[1], g4[0],
                                                   g4[1], g5[0], g5[1])],
                        dim=1)

    def unpack(ln):
        return (ln[0], ln[1]), (ln[2], ln[3]), (ln[4], ln[5])

    f = tw.fp12_one(batch, dev)
    for start, length, is_sqr in _SEGMENTS:
        for step in range(start, start + length):
            if is_sqr:
                f = tw.fp12_sqr_mul_by_045(f, *unpack(lines[step]))
            else:
                f = tw.fp12_mul_by_045(f, *unpack(lines[step]))
    return tw.fp12_conjugate(f)  # z < 0 (pairings.rs:687-691)


def _tree_product(f):
    """Reduce an Fp12 batch [..., n] by multiplication along the LAST batch
    axis with a halving tree (log2 n fp12 products)."""

    def tmap(fn, *xs):
        return tuple(tuple((fn(*(x[i][j][0] for x in xs)),
                            fn(*(x[i][j][1] for x in xs)))
                           for j in range(3)) for i in range(2))

    n = f[0][0][0].shape[-1]
    while n > 1:
        half = n // 2
        lo = tmap(lambda x: x[..., :half], f)
        hi = tmap(lambda x: x[..., half:2 * half], f)
        prod = tw.fp12_mul(lo, hi)
        if n % 2:
            prod = tmap(lambda a, b: torch.cat([a, b[..., -1:]], dim=-1),
                        prod, f)
        f = prod
        n = f[0][0][0].shape[-1]
    return tmap(lambda x: x[..., 0], f)


def multi_miller_loop(p_affs, prep: G2Prepared):
    """Product of the Miller values over the last batch axis (the shared-
    accumulator semantics of pairings.rs:554-603, computed as a batched
    loop and a tree product)."""
    return _tree_product(miller_loop_batched(p_affs, prep))


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------


def _cyclotomic_exp_u(f):
    """f^|z| in the cyclotomic subgroup by the static bit runs of |z|: each
    run of squarings is CYCLO_FUSE-chained plan launches plus single
    squarings for the remainder, then one product by f at a set bit."""

    def sqr_n(acc, n):
        k = tw.CYCLO_FUSE
        for _ in range(n // k):
            acc = tw.fp12_cyclotomic_sqr_k(acc, k)
        for _ in range(n % k):
            acc = tw.fp12_cyclotomic_sqr(acc)
        return acc

    acc = f
    for n_sqr, mul_f in _X_RUNS:
        acc = sqr_n(acc, n_sqr)
        if mul_f:
            acc = tw.fp12_mul(acc, f)
    return acc


def _exp_z(f):
    """f^z = conj(f^|z|) (z is negative; conjugate = inverse in the
    cyclotomic subgroup)."""
    return tw.fp12_conjugate(_cyclotomic_exp_u(f))


def final_exponentiation(f):
    """f^((p^12-1)/q * 3), the reference-compatible final exponentiation
    (cofactor-3 hard part; validated against RELIC)."""
    # easy part: f^((p^6-1)(p^2+1))  (pairings.rs:134-147)
    f = tw.fp12_mul(tw.fp12_conjugate(f), tw.fp12_inv(f))
    f = tw.fp12_mul(tw.fp12_frobenius(tw.fp12_frobenius(f)), f)
    # hard part: l3 = (z-1)^2, l2 = z l3, l1 = z l2 - l3, l0 = z l1 + 3
    fz = _exp_z(f)
    a = tw.fp12_mul(fz, tw.fp12_conjugate(f))            # f^(z-1)
    c = tw.fp12_mul(_exp_z(a), tw.fp12_conjugate(a))     # f^l3
    t3 = c
    t2 = _exp_z(c)                                        # f^l2
    t1 = tw.fp12_mul(_exp_z(t2), tw.fp12_conjugate(c))   # f^l1
    f3 = tw.fp12_mul(tw.fp12_sqr(f), f)                   # f^3
    t0 = tw.fp12_mul(_exp_z(t1), f3)                      # f^l0
    out = tw.fp12_mul(t0, tw.fp12_frobenius(t1))
    out = tw.fp12_mul(out, tw.fp12_frobenius(tw.fp12_frobenius(t2)))
    return tw.fp12_mul(
        out, tw.fp12_frobenius(tw.fp12_frobenius(tw.fp12_frobenius(t3))))


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------


@profiling.spanned("pairing")
def pairing(p_aff, q_aff):
    """e(P_i, Q_i) for batches of affine points (pairings.rs:607-653); the
    spans `pairing.miller` and `pairing.final_exp` inside `pairing`."""
    with profiling.span("pairing.miller"):
        f = miller_loop_batched(p_aff, prepare_g2(q_aff))
    with profiling.span("pairing.final_exp"):
        return final_exponentiation(f)


def pairing_batched(p_aff, q_aff):
    """The JAX package's alias of `pairing` for its batch semantics:
    element-wise e(P_i, Q_i)."""
    return pairing(p_aff, q_aff)
