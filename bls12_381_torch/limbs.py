"""Batched multi-limb modular arithmetic over 16-bit limbs, in PyTorch.

Counterpart of `bls12_381_tpu/limbs.py`, with the same boundary layout:

  - A field element batch is a tensor of shape [L, *batch]: 16-bit limbs,
    little-endian, limb axis first, stored as `torch.int32` (PyTorch on the
    CPU has no add, shift or compare for `uint32`).
  - Montgomery form with R = 2^(16 L) (2^384 for Fp), so values equal the
    reference's and the JAX package's limb for limb.  Every stored value is
    canonical (< p).

Products go to the hand-written kernels of `kernels/mont.py` (`sop`, `sqr`):
on a CUDA tensor the kernel runs, on a CPU tensor its plain PyTorch version.
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
    p_limbs: tuple[int, ...]    # [L]
    one_mont: tuple[int, ...]   # [L], R mod p (Montgomery one)

    @staticmethod
    def make(name: str, modulus: int, n_limbs: int) -> "FieldSpec":
        r = 1 << (LIMB_BITS * n_limbs)
        return FieldSpec(
            name=name,
            modulus=modulus,
            n_limbs=n_limbs,
            inv16=(-pow(modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS),
            p_limbs=tuple(params.to_limbs(modulus, n_limbs)),
            one_mont=tuple(params.to_limbs(r % modulus, n_limbs)),
        )


FP = FieldSpec.make("fp", params.P, params.FP_LIMBS)


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


def sum_of_products(spec: FieldSpec, pairs) -> torch.Tensor:
    """Fused sum_i a_i * b_i with a single Montgomery reduction
    (fp.rs:430-484).  The kernel takes T <= 8 terms, which keeps the
    pre-reduction value below 2p (T p < R); longer sums are chunked into
    fused groups of 8 and the partials added, as the JAX package does."""
    from .kernels import mont

    pairs = list(pairs)
    if len(pairs) > 8:
        parts = [sum_of_products(spec, pairs[i:i + 8])
                 for i in range(0, len(pairs), 8)]
        return functools.reduce(lambda x, y: add(spec, x, y), parts)
    a, b = _stack_pairs(spec, pairs)          # [L, T, *batch]
    a, batch = _flat_batch(a.transpose(0, 1), 2)
    b, _ = _flat_batch(b.transpose(0, 1), 2)  # [T, L, B]
    return mont.sop(a, b).reshape((spec.n_limbs,) + batch)


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """Canonical Montgomery product aR * bR -> abR mod p."""
    return sum_of_products(spec, [(a, b)])


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Canonical Montgomery square through the dedicated squaring kernel
    (off-diagonal products computed once)."""
    from .kernels import mont

    flat, batch = _flat_batch(a, 1)
    return mont.sqr(flat.unsqueeze(0))[0].reshape((spec.n_limbs,) + batch)


def sop_fold(spec: FieldSpec, groups):
    """Many independent sums of products folded into ONE kernel launch.

    groups: G lists of (a, b) pairs (uneven lengths allowed: short groups
    are padded with zero products).  Returns a list of G results."""
    groups = [list(g) for g in groups]
    if len(groups) == 1:
        return [sum_of_products(spec, groups[0])]
    t = max(len(g) for g in groups)
    assert t <= 8, "sop_fold groups are limited to 8 terms"
    batch = torch.broadcast_shapes(
        *[x.shape[1:] for g in groups for pair in g for x in pair])
    full = (spec.n_limbs,) + batch
    any_x = groups[0][0][0]
    zero_el = torch.zeros(full, dtype=DTYPE, device=any_x.device)

    def stacked(term, which):
        return torch.stack(
            [g[term][which].expand(full) if term < len(g) else zero_el
             for g in groups], dim=1)  # [L, G, *batch]

    pairs = [(stacked(i, 0), stacked(i, 1)) for i in range(t)]
    return list(sum_of_products(spec, pairs).unbind(1))


def mul_many(spec: FieldSpec, pairs):
    """Independent products a_i * b_i folded into one kernel launch."""
    return sop_fold(spec, [[p] for p in pairs])


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


# ---------------------------------------------------------------------------
# Exponentiation by a fixed public exponent
# ---------------------------------------------------------------------------


POW_WINDOW = 4  # bits per digit of pow_fixed, the JAX package's default


def pow_fixed(spec: FieldSpec, a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent by MSB-first fixed-window square-and-multiply.

    The exponent is a public Python int, so the digit schedule and the table
    lookups are static: each window is POW_WINDOW squarings and one product
    by the table entry of its digit, the JAX package's schedule (zero-padded
    to the field's bit width, digit 0 multiplying by one)."""
    full = one(spec, a.shape[1:], device=a.device)
    if exponent == 0:
        return full
    width = max(exponent.bit_length(), spec.modulus.bit_length())
    n_digits = -(-width // POW_WINDOW)
    mask = (1 << POW_WINDOW) - 1
    digits = [(exponent >> (POW_WINDOW * (n_digits - 1 - i))) & mask
              for i in range(n_digits)]
    table = [full, a.expand(full.shape)]
    for _ in range(2, 1 << POW_WINDOW):
        table.append(mont_mul(spec, table[-1], a))
    acc = full
    for d in digits:
        for _ in range(POW_WINDOW):
            acc = mont_sqr(spec, acc)
        acc = mont_mul(spec, acc, table[d])
    return acc


def inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a^(p-2); maps 0 to 0 (callers mask identity cases)."""
    return pow_fixed(spec, a, spec.modulus - 2)


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
