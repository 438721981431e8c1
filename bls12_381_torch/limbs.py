"""Batched multi-limb modular arithmetic over 16-bit limbs, in PyTorch.

Counterpart of `bls12_381_tpu/limbs.py`, with the same boundary layout:

  - A field element batch is a tensor of shape [L, *batch]: 16-bit limbs,
    little-endian, limb axis first, stored as `torch.int32` (PyTorch on the
    CPU has no add, shift or compare for `uint32`).
  - Montgomery form with R = 2^(16 L) (2^384 for Fp, 2^256 for Fr), so
    values equal the reference's and the JAX package's limb for limb.
    Every stored value is canonical (< p).

Sums of products and folds go to the hand-written row kernel of
`kernels/mont.py` (`sop_rows`), which reads each operand where the caller
holds it: it counts as `sop` (Fp, one group), `fold_planned` (Fp, two or
more groups) or `sop_fr` (Fr).  Fp squares go to `sqr`, and
fixed-exponent powers (`pow_fixed`, `inv`) to one launch of `pow_fixed` /
`pow_fixed_fr`: on a CUDA tensor the kernel runs, on a CPU tensor its plain
PyTorch version.
The additive glue (add/sub/neg, `add_many`/`sub_many`, `select`) is plain
PyTorch on every device, as it is plain jnp in the JAX package: it works in
int64 and resolves carry chains with the packed-adder trick of `_kogge_stone`
instead of a Python loop over limbs.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import params

LIMB_BITS = params.LIMB_BITS
MASK = params.LIMB_MASK
DTYPE = torch.int32  # storage type of limbs at every public boundary


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field in limb form."""

    name: str
    modulus: int
    n_limbs: int
    inv16: int                  # -p^-1 mod 2^16
    max_terms: int              # products one fused reduction takes
    p_limbs: tuple[int, ...]    # [L]
    one_mont: tuple[int, ...]   # [L], R mod p (Montgomery one)
    r2_limbs: tuple[int, ...]   # [L], R^2 mod p (Montgomery conversion)
    r3_limbs: tuple[int, ...]   # [L], R^3 mod p (wide-byte reduction)

    @staticmethod
    def make(name: str, modulus: int, n_limbs: int) -> "FieldSpec":
        r = 1 << (LIMB_BITS * n_limbs)
        return FieldSpec(
            name=name,
            modulus=modulus,
            n_limbs=n_limbs,
            inv16=(-pow(modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS),
            # T products reduce to < T p^2 / R + p, which one conditional
            # subtraction makes canonical while T p < R: 8 for Fp (R/p ~
            # 9.84, capped at the JAX package's chunk), 2 for Fr (R/q ~ 2.21)
            max_terms=min(8, (r - 1) // modulus),
            p_limbs=tuple(params.to_limbs(modulus, n_limbs)),
            one_mont=tuple(params.to_limbs(r % modulus, n_limbs)),
            r2_limbs=tuple(params.to_limbs(r * r % modulus, n_limbs)),
            r3_limbs=tuple(params.to_limbs(r * r * r % modulus, n_limbs)),
        )


FP = FieldSpec.make("fp", params.P, params.FP_LIMBS)
FR = FieldSpec.make("fr", params.Q, params.FR_LIMBS)


def resolve_device(device) -> torch.device:
    """The torch device for a constructor or entry point; raises when CUDA
    is asked for and there is no card (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bls12_381_torch: device='cuda' was requested but no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path")
    return dev


@functools.lru_cache(maxsize=None)
def _const_tensor(vals: tuple, device: torch.device, dtype) -> torch.Tensor:
    return torch.tensor(vals, dtype=dtype, device=device)


def _col(vals, like: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
    """A [n] constant shaped [n, 1, ...] to broadcast against [n, *batch]."""
    t = _const_tensor(tuple(vals), like.device, dtype)
    return t.reshape((len(vals),) + (1,) * (like.dim() - 1))


# ---------------------------------------------------------------------------
# Carry propagation and canonical reduction (int64 internally)
# ---------------------------------------------------------------------------


def _kogge_stone(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Carry OUT of each position of a chain with per-limb generate and
    propagate bits g, p ([K, *batch] bool, K <= 62), as int64 0/1.

    The bits of all K limbs are packed into one int64 per lane and the chain
    is resolved with the packed-adder identity A = G | P', S = A + G,
    carry-in bits = S ^ A ^ G (P' = propagate and not generate).
    """
    K = g.shape[0]
    w = _col(tuple(range(K)), g)
    gi = g.long()
    G = (gi << w).sum(0)
    Pp = ((p & ~g).long() << w).sum(0)
    A = G | Pp
    carry_in = (A + G) ^ A ^ G  # bit k = carry INTO position k
    return (carry_in.unsqueeze(0) >> (w + 1)) & 1


def _shift_up(c: torch.Tensor) -> torch.Tensor:
    """Row k of the result is row k-1 of c (row 0 is zero)."""
    return torch.cat([torch.zeros_like(c[:1]), c[:-1]])


def _carry_prop_1bit(s: torch.Tensor, n_out: int) -> torch.Tensor:
    """Normalize limbwise sums s ([K, *batch], each < 2^16 + 2^16 with the
    limb's low half < 2^16 - 1 whenever its carry bit is set) into n_out
    clean 16-bit limbs."""
    lo = s & MASK
    g = (s >> LIMB_BITS) != 0
    p = lo == MASK
    carry_out = _kogge_stone(g, p)
    out = (lo + _shift_up(carry_out)) & MASK
    K = s.shape[0]
    if n_out > K:
        pad = torch.zeros((n_out - K - 1,) + s.shape[1:], dtype=s.dtype,
                          device=s.device)
        out = torch.cat([out, carry_out[-1:], pad])
    return out[:n_out]


def _carry_prop(t: torch.Tensor, n_out: int, passes: int) -> torch.Tensor:
    """Normalize lazy columns into n_out clean limbs: `passes` shift-add
    passes bring every column below 2^16 + 2^11 (each pass takes 16 bits
    off the carries), then one carry-lookahead resolves the 1-bit carries.
    The columns' value must fit the K columns (no carry out of the top)."""
    for _ in range(passes):
        t = (t & MASK) + _shift_up(t >> LIMB_BITS)
    return _carry_prop_1bit(t, n_out)


def _sub_limbs(a: torch.Tensor, b: torch.Tensor, n: int):
    """a - b over n limbs via borrow-lookahead: (diff [n, *batch], borrow
    [*batch]), both int64."""
    a, b = torch.broadcast_tensors(a[:n], b[:n])
    borrow_out = _kogge_stone(a < b, a == b)
    diff = (a - b - _shift_up(borrow_out)) & MASK
    return diff, borrow_out[-1]


def _cond_sub_p(spec: FieldSpec, t: torch.Tensor) -> torch.Tensor:
    """t - p if t >= p else t, as L limbs; t is L or L+1 clean limbs with
    value < 2p."""
    L, n_in = spec.n_limbs, t.shape[0]
    p_ext = spec.p_limbs + (0,) * (n_in - L)
    diff, borrow = _sub_limbs(t, _col(p_ext, t), n_in)
    return torch.where((borrow == 0).unsqueeze(0), diff[:L], t[:L])


# ---------------------------------------------------------------------------
# Add / sub / neg (reference semantics: fp.rs:361-427)
# ---------------------------------------------------------------------------


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    t = _carry_prop_1bit(a.long() + b.long(), spec.n_limbs + 1)
    return _cond_sub_p(spec, t).to(DTYPE)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    diff, borrow = _sub_limbs(a.long(), b.long(), spec.n_limbs)
    # on a borrow add p back (mod 2^(16 L))
    fix = _col(spec.p_limbs, diff) * borrow.unsqueeze(0)
    return _carry_prop_1bit(diff + fix, spec.n_limbs).to(DTYPE)


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    a64 = a.long()
    diff, _ = _sub_limbs(_col(spec.p_limbs, a64), a64, spec.n_limbs)
    # p - 0 = p must map back to 0
    return torch.where(is_zero(a).unsqueeze(0), torch.zeros_like(diff),
                       diff).to(DTYPE)


def double(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return add(spec, a, a)


def _stack_pairs(spec: FieldSpec, pairs):
    """Stack K operand pairs along a new axis 1: ([L, K, *batch]) x 2."""
    batch = torch.broadcast_shapes(*[x.shape[1:] for p in pairs for x in p])
    full = (spec.n_limbs,) + batch
    a = torch.stack([x.expand(full) for x, _ in pairs], dim=1)
    b = torch.stack([y.expand(full) for _, y in pairs], dim=1)
    return a, b


def add_many(spec: FieldSpec, pairs):
    """K independent modular additions in ONE carry network; returns a
    list."""
    pairs = list(pairs)
    if len(pairs) == 1:
        return [add(spec, *pairs[0])]
    a, b = _stack_pairs(spec, pairs)
    return list(add(spec, a, b).unbind(1))


def sub_many(spec: FieldSpec, pairs):
    """K independent modular subtractions in ONE borrow network."""
    pairs = list(pairs)
    if len(pairs) == 1:
        return [sub(spec, *pairs[0])]
    a, b = _stack_pairs(spec, pairs)
    return list(sub(spec, a, b).unbind(1))


def neg_many(spec: FieldSpec, xs):
    """K independent negations in ONE borrow network."""
    xs = list(xs)
    if len(xs) == 1:
        return [neg(spec, xs[0])]
    batch = torch.broadcast_shapes(*[x.shape[1:] for x in xs])
    full = (spec.n_limbs,) + batch
    return list(neg(spec, torch.stack([x.expand(full) for x in xs], 1))
                .unbind(1))


# ---------------------------------------------------------------------------
# Montgomery products (kernels/mont.py)
# ---------------------------------------------------------------------------


def _flat_batch(x: torch.Tensor, lead: int):
    """[*lead_dims, *batch] -> ([*lead_dims, B] contiguous, batch shape)."""
    batch = x.shape[lead:]
    return x.reshape(x.shape[:lead] + (-1,)).contiguous(), batch


def _broadcast(shapes) -> tuple:
    """`torch.broadcast_shapes` of batch shapes, in plain Python (the
    torch function costs more host time than a product's launch)."""
    out = []
    for shape in shapes:
        if len(shape) > len(out):
            out = [1] * (len(shape) - len(out)) + out
        for i, d in enumerate(shape, len(out) - len(shape)):
            if d != 1 and out[i] != d:
                if out[i] != 1:
                    raise ValueError(f"batch shapes {list(shapes)} do not "
                                     "broadcast")
                out[i] = d
    return tuple(out)


def _fold_launch(spec: FieldSpec, groups, batch):
    """Groups of <= spec.max_terms terms in one `mont.sop_rows` launch per
    chunk of at most FOLD_ENTRIES table entries.  Each distinct operand
    tensor is one row, keyed by the id() of the caller's tensor objects
    (which `groups` keeps alive for the call), passed as it is."""
    from .kernels import mont

    t = max(len(g) for g in groups)
    per_call = mont.FOLD_ENTRIES // t
    if len(groups) > per_call:
        return [r for i in range(0, len(groups), per_call)
                for r in _fold_launch(spec, groups[i:i + per_call], batch)]
    rows, ids = [], {}

    def reg(x):
        k = ids.get(id(x))
        if k is None:
            k = ids[id(x)] = len(rows)
            rows.append(x)
        return k

    ia = [[reg(a) for a, _ in g] + [0] * (t - len(g)) for g in groups]
    ib = [[reg(b) for _, b in g] + [0] * (t - len(g)) for g in groups]
    out = mont.sop_rows(spec, rows, ia, ib, [len(g) for g in groups], batch)
    return list(out.unbind(0))


def _fold(spec: FieldSpec, groups):
    """Fused sums of products of G groups (fp.rs:430-484): terms in chunks
    of spec.max_terms per group, which keeps each pre-reduction value below
    2p; a chunk of every group that has one is one `_fold_launch`, and a
    group's partials are added."""
    operands = {id(x): x for g in groups for pair in g for x in pair}
    batch = _broadcast([x.shape[1:] for x in operands.values()])
    k = spec.max_terms
    acc = [None] * len(groups)
    for c in range(0, max(len(g) for g in groups), k):
        live = [gi for gi, g in enumerate(groups) if len(g) > c]
        parts = _fold_launch(spec, [groups[gi][c:c + k] for gi in live],
                             batch)
        for gi, part in zip(live, parts):
            acc[gi] = part if acc[gi] is None else add(spec, acc[gi], part)
    return acc


def sum_of_products(spec: FieldSpec, pairs) -> torch.Tensor:
    """Fused sum_i a_i * b_i with a single Montgomery reduction
    (fp.rs:430-484), through the field's row kernel (`mont.sop_rows`, one
    group: a `sop` launch for Fp, `sop_fr` for Fr) with the operands read
    where they lie.  One launch takes T <= spec.max_terms terms, which
    keeps the pre-reduction value below 2p; longer sums are chunked into
    fused groups of max_terms and the partials added.

    The JAX package chunks at 8 for both fields (limbs.py:431-436), so an Fr
    sum of 3..8 terms comes out of its single subtraction possibly >= q.  No
    JAX caller sums more than 2 Fr terms (fr.py and ntt.py use 1), so
    chunking Fr at 2 keeps parity while every port value stays canonical."""
    return _fold(spec, [list(pairs)])[0]


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """Canonical Montgomery product aR * bR -> abR mod p."""
    return sum_of_products(spec, [(a, b)])


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Canonical Montgomery square: for Fp through the dedicated squaring
    kernel (off-diagonal products computed once); for Fr a product with
    a == b, as `sqr_pallas` falls back to `sop_pallas` (pallas_mont.py:
    726-740)."""
    from .kernels import mont

    if spec.name == FR.name:
        return mont_mul(spec, a, a)
    flat, batch = _flat_batch(a, 1)
    return mont.sqr(flat.unsqueeze(0))[0].reshape((spec.n_limbs,) + batch)


def sop_fold(spec: FieldSpec, groups):
    """Many independent sums of products folded into ONE kernel launch.

    groups: G lists of (a, b) pairs, T <= 8 terms (uneven lengths allowed:
    each group's term count travels with the launch).  Returns a list of G
    results.  The operands are deduplicated by id() and read where they lie
    (`mont.sop_rows`, the JAX `_sop_fold_planned` route, limbs.py:446-486,
    on every device, with no operand stack); a table beyond the kernel's
    G T cap runs as launches over chunks of groups.  Fr folds take the
    same kernel in chunks of 2 terms per group, with the partials added.
    A single group is one sum of products."""
    groups = [list(g) for g in groups]
    assert max(len(g) for g in groups) <= 8, \
        "sop_fold groups are limited to 8 terms"
    return _fold(spec, groups)


def mul_many(spec: FieldSpec, pairs):
    """Independent products a_i * b_i folded into one kernel launch."""
    return sop_fold(spec, [[p] for p in pairs])


# ---------------------------------------------------------------------------
# Plain (non-modular) integer helpers: the GLV/GLS scalar splits
# ---------------------------------------------------------------------------


def _pad_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    """The first n limb rows of a, zero-padded below (int64)."""
    a = a.long()
    if a.shape[0] >= n:
        return a[:n]
    return torch.cat([a, a.new_zeros((n - a.shape[0],) + a.shape[1:])])


def plain_mul_const(a: torch.Tensor, const: int, n_out: int) -> torch.Tensor:
    """Exact product of a limb tensor [n, *batch] with a static nonnegative
    integer, truncated to n_out 16-bit limbs (mod 2^(16 n_out))."""
    assert const >= 0
    n = a.shape[0]
    m = params.to_limbs(const, max(const.bit_length() + 15, 16) // 16)
    a64 = a.long()
    # every column < min(n, len(m)) 2^32 < 2^40; n + len(m) columns hold
    # the whole product, so the shift-add passes drop no carry
    cols = a64.new_zeros((n + len(m),) + a.shape[1:])
    for j, mj in enumerate(m):
        if mj:
            cols[j:j + n] += a64 * mj
    return _carry_prop(cols, n_out, passes=3).to(DTYPE)


def shift_right_limbs(a: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """Drop the low n_limbs 16-bit limbs (a >> 16 n_limbs)."""
    return a[n_limbs:]


def plain_sub(a: torch.Tensor, b: torch.Tensor, n: int):
    """Exact a - b over n limbs: (diff int32 [n, *batch], borrow mask)."""
    diff, borrow = _sub_limbs(_pad_rows(a, n), _pad_rows(b, n), n)
    return diff.to(DTYPE), borrow != 0


def plain_geq(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """a >= b over n limbs."""
    _, borrow = _sub_limbs(_pad_rows(a, n), _pad_rows(b, n), n)
    return borrow == 0


def barrett_divmod(a: torch.Tensor, d: int, q_limbs: int):
    """(floor(a / d), a mod d) for an n-limb tensor and a static divisor d:
    q_hat = floor(a M / 2^(16 n)) with M = floor(2^(16 n) / d) is the
    quotient or one below it, fixed by one masked correction.  Returns
    (q [q_limbs, *batch], r [n, *batch]).

    PRECONDITION (the caller's; the quotient is silently truncated
    otherwise): floor(max(a) / d) < 2^(16 q_limbs).  q_limbs may come from
    the VALUE bound of a rather than its limb count: the GLS split divides
    a 16-limb tensor known to be < x^3 by x^2 with q_limbs = 5."""
    n = a.shape[0]
    q = shift_right_limbs(plain_mul_const(a, (1 << (16 * n)) // d,
                                          n + q_limbs), n)
    r, _ = plain_sub(a, plain_mul_const(q, d, n), n)  # exact: q d <= a
    d_col = _col(params.to_limbs(d, n), r, DTYPE)
    too_big = plain_geq(r, d_col, n)
    r_fix, _ = plain_sub(r, d_col, n)
    bump = _col((1,) + (0,) * (q_limbs - 1), q)
    q_fix = _carry_prop_1bit(q.long() + bump, q_limbs).to(DTYPE)
    return select(too_big, q_fix, q), select(too_big, r_fix, r)


def digits4_msb(limbs_tensor: torch.Tensor, n_bits: int) -> torch.Tensor:
    """[n, *batch] 16-bit limbs -> [ceil(n_bits / 4), *batch] int32 4-bit
    digits, MSB first (each limb holds four aligned digits)."""
    a = limbs_tensor
    n_digits = -(-n_bits // 4)
    x = a[:-(-n_digits // 4)].long()
    shifts = _const_tensor((0, 4, 8, 12), a.device, torch.int64).reshape(
        (1, 4) + (1,) * (a.dim() - 1))
    d = (x.unsqueeze(1) >> shifts) & 15  # [limbs, 4, *batch], LSB first
    return d.reshape((-1,) + a.shape[1:])[:n_digits].flip(0).to(DTYPE)


def signed_digits_lsb(a: torch.Tensor, n_bits: int, window: int = 4):
    """Balanced window digits of canonical limb tensors [n, *batch], LSB
    first: (mags, negs), [n_digits, *batch] int32 magnitudes in
    [0, 2^(window-1)] and sign masks, n_digits = ceil((n_bits + 1) / window)
    so that the last carry fits a non-negative top digit (which is never
    folded into the signed range).  The recoding runs LSB first with a
    carry, in int64 (limbs.py:629-664 of the JAX package)."""
    n_digits = -(-(n_bits + 1) // window)
    half, full = 1 << (window - 1), 1 << window
    x = a.long()
    mags, negs = [], []
    carry = 0
    for w in range(n_digits):
        lo_bit = window * w
        raw = torch.zeros_like(x[0])
        # the limbs the window touches; a part below it shifts right
        for limb in range(lo_bit // LIMB_BITS,
                          min((lo_bit + window - 1) // LIMB_BITS + 1,
                              a.shape[0])):
            shift = limb * LIMB_BITS - lo_bit
            raw |= x[limb] << shift if shift >= 0 else x[limb] >> -shift
        t = (raw & (full - 1)) + carry
        if w == n_digits - 1:
            d = t
        else:
            borrow = t >= half
            d = torch.where(borrow, t - full, t)
            carry = borrow.long()
        mags.append(d.abs())
        negs.append(d < 0)
    return torch.stack(mags).to(DTYPE), torch.stack(negs)


def signed_digits_msb(limbs_tensor: torch.Tensor, n_bits: int,
                      window: int = 4):
    """`signed_digits_lsb` with the digits MSB first, the order the
    scalar multiplications read them in."""
    mags, negs = signed_digits_lsb(limbs_tensor, n_bits, window)
    return mags.flip(0), negs.flip(0)


# ---------------------------------------------------------------------------
# Predicates / selection
# ---------------------------------------------------------------------------


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """mask ? a : b, with mask of shape [*batch]."""
    return torch.where(mask.unsqueeze(0), a, b)


def gt_half(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a > (m-1)/2 for canonical limbs, i.e. `lexicographically_largest`
    (fp.rs:273): no borrow out of a - (m+1)/2."""
    a64 = a.long()
    half = params.to_limbs((spec.modulus + 1) // 2, spec.n_limbs)
    _, borrow = _sub_limbs(a64, _col(half, a64), spec.n_limbs)
    return borrow == 0


def sgn0(a: torch.Tensor) -> torch.Tensor:
    """Parity of the canonical value (draft-16 sgn0 for m = 1), int32."""
    return a[0] & 1


# ---------------------------------------------------------------------------
# Exponentiation by a fixed public exponent
# ---------------------------------------------------------------------------


def pow_fixed(spec: FieldSpec, a: torch.Tensor, exponent: int,
              window: int = 4) -> torch.Tensor:
    """a^exponent for a public exponent (a Python int): the whole fixed-
    window square-and-multiply chain in ONE launch of the field's power
    kernel (`mont.pow_fixed` for Fp, `mont.pow_fixed_fr` for Fr) over the
    flattened batch.  On a CPU tensor its plain version runs the JAX
    package's schedule (limbs.py:693-735); every step is canonical, so the
    values agree limb for limb.  The kernel's digits are `window` = 4 bits
    (`mont.POW_WINDOW`, the JAX default); any other window raises
    ValueError, on every device."""
    from .kernels import mont

    if window != mont.POW_WINDOW:
        raise ValueError(f"pow_fixed: window {window!r}; the power kernel "
                         f"takes {mont.POW_WINDOW}-bit digits only")
    if exponent == 0:
        return one(spec, a.shape[1:], device=a.device)
    flat, batch = _flat_batch(a, 1)
    fn = {FP.name: mont.pow_fixed, FR.name: mont.pow_fixed_fr}[spec.name]
    return fn(flat, exponent).reshape((spec.n_limbs,) + batch)


def pow_runtime(spec: FieldSpec, a: torch.Tensor,
                exp_limbs: torch.Tensor) -> torch.Tensor:
    """a^e with a runtime exponent tensor (`ff::Field::pow`, scalar.rs:
    373-390): exp_limbs are canonical 16-bit limb rows [n, *batch] (e.g.
    `from_mont(FR, s)`).  MSB-first square-and-multiply over all 16 n bits
    with a masked multiply per bit, the JAX package's constant schedule."""
    acc = one(spec, a.shape[1:], device=a.device)
    for j in range(LIMB_BITS * exp_limbs.shape[0] - 1, -1, -1):
        acc = mont_sqr(spec, acc)
        bit = ((exp_limbs[j // LIMB_BITS] >> (j % LIMB_BITS)) & 1) != 0
        acc = select(bit, mont_mul(spec, acc, a), acc)
    return acc


def inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a^(p-2); maps 0 to 0 (callers mask identity cases)."""
    return pow_fixed(spec, a, spec.modulus - 2)


def _prefix_products(spec: FieldSpec, x: torch.Tensor,
                     one1: torch.Tensor) -> torch.Tensor:
    """Inclusive product scan along the last axis (`utils/scans.py`)."""
    from .utils import scans

    return scans.inclusive_scan(lambda a, b: mont_mul(spec, a, b), x, one1)


def batch_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse amortized over the LAST batch axis (g1.rs:
    806-839): prefix and suffix product scans, ONE inversion of the total,
    and two products per lane.  Zeros invert to zero.  Below 16 lanes it is
    one `inv` per lane, as in the JAX package."""
    if (a.shape[-1] if a.dim() > 1 else 0) < 16:
        return inv(spec, a)
    zero_mask = is_zero(a)
    safe = select(zero_mask, one(spec, a.shape[1:], device=a.device), a)
    one1 = one(spec, a.shape[1:-1] + (1,), device=a.device)
    pre = _prefix_products(spec, safe, one1)
    suf = _prefix_products(spec, safe.flip(-1), one1).flip(-1)
    pre_excl = torch.cat([one1, pre[..., :-1]], dim=-1)
    suf_excl = torch.cat([suf[..., 1:], one1], dim=-1)
    total_inv = inv(spec, pre[..., -1])
    others = mont_mul(spec, pre_excl, suf_excl)  # prod_{j != i} a_j
    out = mont_mul(spec, others, total_inv.unsqueeze(-1))
    return select(zero_mask, torch.zeros_like(out), out)


# ---------------------------------------------------------------------------
# Host <-> device codecs
# ---------------------------------------------------------------------------


def from_ints(spec: FieldSpec, values, to_mont: bool = True,
              device="cuda") -> torch.Tensor:
    """Python ints -> [L, *shape] int32 limbs (Montgomery form by default)."""
    arr = np.asarray(values, dtype=object)
    flat = arr.reshape(-1)
    r = 1 << (LIMB_BITS * spec.n_limbs)
    out = np.zeros((spec.n_limbs, flat.size), dtype=np.int32)
    for idx, v in enumerate(flat):
        v = int(v) % spec.modulus
        if to_mont:
            v = v * r % spec.modulus
        out[:, idx] = params.to_limbs(v, spec.n_limbs)
    dev = resolve_device(device)
    return torch.from_numpy(out.reshape((spec.n_limbs,) + arr.shape)).to(dev)


def to_ints(spec: FieldSpec, a: torch.Tensor, from_mont: bool = True):
    """[L, *batch] limbs -> numpy object array of Python ints (or one int
    for an empty batch shape)."""
    arr = a.detach().cpu().numpy().astype(np.int64)
    batch = arr.shape[1:]
    flat = arr.reshape(spec.n_limbs, -1)
    r_inv = pow(1 << (LIMB_BITS * spec.n_limbs), -1, spec.modulus)
    out = np.empty(flat.shape[1], dtype=object)
    for idx in range(flat.shape[1]):
        v = params.from_limbs(flat[:, idx])
        out[idx] = v * r_inv % spec.modulus if from_mont else v
    return out.reshape(batch) if batch else out[0]


def const(spec: FieldSpec, value: int, batch_shape=(), device="cuda"):
    """A Montgomery-encoded constant broadcast over a batch shape (an
    expanded view: no copy per lane)."""
    r = 1 << (LIMB_BITS * spec.n_limbs)
    v = int(value) % spec.modulus * r % spec.modulus
    t = _const_tensor(tuple(params.to_limbs(v, spec.n_limbs)),
                      resolve_device(device), DTYPE)
    batch_shape = tuple(batch_shape)
    return t.reshape((spec.n_limbs,) + (1,) * len(batch_shape)).expand(
        (spec.n_limbs,) + batch_shape)


def zero(spec: FieldSpec, batch_shape=(), device="cuda") -> torch.Tensor:
    return torch.zeros((spec.n_limbs,) + tuple(batch_shape), dtype=DTYPE,
                       device=resolve_device(device))


def one(spec: FieldSpec, batch_shape=(), device="cuda") -> torch.Tensor:
    return const(spec, 1, batch_shape, device)


def to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Canonical residue -> Montgomery form (a product with R^2)."""
    return mont_mul(spec, a, _col(spec.r2_limbs, a, DTYPE))


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical residue (a product with plain 1)."""
    raw_one = (1,) + (0,) * (spec.n_limbs - 1)
    return mont_mul(spec, a, _col(raw_one, a, DTYPE))


def wide_reduce(spec: FieldSpec, lo: torch.Tensor, hi: torch.Tensor):
    """(lo + hi R) mod p in Montgomery form, for raw limb tensors lo, hi
    (any value < R): lo R^2 R^-1 + hi R^3 R^-1 (scalar.rs:300-331).  A
    product with one canonical operand reduces to < R p / R + p = 2p, so
    the raw inputs are legal for the kernels too.  Both products are one
    fold."""
    return add(spec, *mul_many(spec, [(lo, _col(spec.r2_limbs, lo, DTYPE)),
                                      (hi, _col(spec.r3_limbs, hi, DTYPE))]))
