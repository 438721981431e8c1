"""Montgomery sum-of-products, squaring, the planned fold, the NTT
butterfly and the fixed-exponent power: CUDA kernels and plain versions.

`sop` replaces `bls12_381_tpu/kernels/pallas_mont.py::sop_pallas` for Fp
(default body `_sop_kernel_r12_scalar`), `sqr` replaces `sqr_pallas` (default
body `_sqr_kernel_r12_scalar`), `fold_planned` replaces
`fold_planned_pallas` (bodies `_fold_planned_kernel_r12_scalar`,
`_fold_planned_kernel_r12`); source `csrc/mont.cu` on `csrc/fp384.cuh`.
`sop_fr` replaces `sop_pallas`'s Fr route (body `_sop_kernel_reg`, chosen at
pallas_mont.py:682-689), `butterfly` replaces `butterfly_pallas` (bodies
`_butterfly_kernel_16`, `_butterfly_kernel_16_vec`); source `csrc/fr.cu` on
`csrc/fr256.cuh`.  Both sources instantiate the word-level Montgomery code of
`csrc/montgomery.cuh` with their field header's struct; `sop` and `sop_fr`
are its one sum-of-products kernel template, built for p and for q.
`pow_fixed` (Fp, `csrc/mont.cu`) and `pow_fixed_fr` (Fr, `csrc/fr.cu`) are
its fixed-exponent power template: the JAX package's `limbs.pow_fixed`
(limbs.py:693, a scan of `sqr_pallas` and `sop_pallas` launches: 14 table
products, then 4 squares and a product per 4-bit digit) in one launch, so
`sqr_pallas`'s body (`sqr_wide`) reaches the paths through it.

Design.  One thread per batch lane; the lane axis is innermost, so a warp's
loads of one limb row are 32 neighbouring words.  The 16-bit limbs of each
operand are packed into 32-bit words in registers (12 for Fp, 8 for Fr), the
T products are summed into a 2W+1-word accumulator with 32x32->64-bit
multiply-adds, then one Montgomery reduction with 32-bit digits (W rounds,
m = t0 * (-p^-1 mod 2^32)) and one conditional subtraction give the
canonical result, unpacked to 16-bit limbs.  The pre-reduction value is
< T p^2, so the result is < T p^2/R + p, which is < 2p while T p < R:
R/p ~ 9.84 gives the Fp kernel T <= 8 (the JAX package's chunk), R/q ~ 2.21
gives the Fr kernel T <= 2 (`limbs.FieldSpec.max_terms`).  The canonical
Montgomery value is unique for R, so the 32-bit digits cannot change a
result (`pallas_mont.py:96-105`).  The fold is the same per-lane routine
(`montgomery.cuh`'s `sop_lane`) with one thread per (lane, group), the
group on the grid's y axis: term t of group g multiplies rows ia[g, t] and
ib[g, t] of a deduplicated operand stack, whose row 0 is zeros for the
padding terms.  The [G, T] index tables are copied into the launch's
parameter block (uint16 entries, G T <= FOLD_ENTRIES), so no call copies
them host-to-device.  The butterfly is one Fr product
t = b w R^-1 followed by a + t and a - t mod q, all in registers; 2q < 2^256,
so a + t never carries out of the 8 words.  The power kernel runs
one lane's whole chain in one thread: the exponent's digits by value in
the launch's parameter block (uint8, up to POW_DIGITS), the window table
in shared memory (16 x W words per lane, lane innermost), the accumulator
in registers; it skips the leading zero digits and the products by entry
0 (R mod p), which leaves every canonical value as the JAX schedule has
it.  A block holds 128 lanes (`kPowLanes`, fixed at compile time): at
B = 1024 a launch at p - 2 took 0.560 ms with 128 lanes per block, 0.635
with 64 and 0.708 with 32, and 0.556 at B = 1 (`chip_smoke.py`, NVIDIA
H100 80GB HBM3 at 700 W; PERF.md).  Why the smaller blocks are slower has
not been traced.

Bound on the card.  A T = 1 Fp product reads 2 x 24 and writes 24 int32
words per lane (288 bytes) and does 2 x 12 x 12 word products plus the
reduction's 12 x 12 + 12, each a lo and a hi 32-bit multiply: about 600
IMADs per lane.  At 3.35 TB/s and 132 SMs x 64 IMAD/clock x 1.98 GHz the
bytes take ~2.4x longer than the multiplies, so T = 1 is bound by memory:
16-bit limbs stored in int32 double the bytes read.  Larger T moves toward
the multiply bound.  The fold's bound counts each of its K distinct rows
read once and G rows written; the simple kernel reads a row once per term
that names it, so it gains over the stacked `sop` only the copies the
stack no longer makes.  The butterfly reads 3 x 64 and writes 2 x 64 bytes per
lane (320 bytes) for about 270 IMADs: bound by memory, ~50 us per NTT stage
of 2^19 lanes.  A power moves 2 L words per lane but runs ~480 dependent
products (p - 2): at B = 1024 its multiplies are ~14 us of the card's
rate, spread over only 32 warps, so its time is the chain's latency.
The kernels keep every intermediate in registers (nothing
but the operands and the result touches device memory); packing the
boundary to 32-bit words would halve their bytes and is left to a later
change.

On a CPU tensor the wrappers run the plain versions below (int64 PyTorch
following the JAX jnp algorithms, `limbs.py:280-327`); on a CUDA tensor they
launch the kernel or raise.  Nothing sends a CUDA tensor to the plain path.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import limbs
from . import LAUNCHES, build

L = limbs.FP.n_limbs
L_FR = limbs.FR.n_limbs
MAX_TERMS = limbs.FP.max_terms
MAX_TERMS_FR = limbs.FR.max_terms
FOLD_ENTRIES = 512        # G T entries of the fold's by-value index tables
FOLD_OPERANDS = 1 << 16   # rows of its operand stack (uint16 indices)

POW_WINDOW = 4            # bits per digit of pow_fixed (the JAX default)
POW_DIGITS = 256          # digits the pow kernel takes by value (1024 bits)

_POW_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p)
_SIGNATURES = {
    # (a, b, out, T, B, stream)
    "bls_sop": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
    # (a, out, G, B, stream)
    "bls_sqr": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p),
    # (ops, ia, ib [host int32], out, K, G, T, B, stream)
    "bls_fold_planned": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
    # (a, out, digits [host uint8], n_digits, B, stream)
    "bls_pow_fixed": _POW_ARGS,
}
_SIGNATURES_FR = {
    # (a, b, out, T, B, stream)
    "bls_sop_fr": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p),
    # (a, b, w, out, B, stream)
    "bls_butterfly": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p),
    # (a, out, digits [host uint8], n_digits, B, stream)
    "bls_pow_fixed_fr": _POW_ARGS,
}


def _lib():
    return build.load("mont", _SIGNATURES)


def _lib_fr():
    return build.load("fr", _SIGNATURES_FR)


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def _check_limbs(x: torch.Tensor, name: str, n_limbs: int = L) -> None:
    if x.dtype != limbs.DTYPE or x.dim() != 3 or x.shape[1] != n_limbs:
        raise ValueError(f"{name}: expected int32 [n, {n_limbs}, B], got "
                         f"{tuple(x.shape)} {x.dtype}")


def _check_pair(a: torch.Tensor, b: torch.Tensor, name: str) -> None:
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"{name}: operands differ: {tuple(a.shape)} on "
                         f"{a.device} vs {tuple(b.shape)} on {b.device}")


def device_kind(x: torch.Tensor) -> str:
    """'cpu' (plain version) or 'cuda' (kernel); any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ---------------------------------------------------------------------------
# Plain versions (int64 over 16-bit limbs)
# ---------------------------------------------------------------------------


def _mont_reduce_plain(spec: limbs.FieldSpec, t: torch.Tensor):
    """Montgomery reduction of [2L+1, *batch] int64 lazy columns (each
    < 2^43) to canonical limbs: L rounds of 16-bit digits
    m = t_k * inv16 mod 2^16 (the jnp `_mont_reduce`, fp.rs:487-562)."""
    n = spec.n_limbs
    p = limbs._col(spec.p_limbs, t)
    for k in range(n):
        m = (t[k] * spec.inv16) & limbs.MASK
        t[k:k + n] += m.unsqueeze(0) * p
        t[k + 1] += t[k] >> limbs.LIMB_BITS
    out = limbs._carry_prop(t[n:], n + 1, passes=2)
    return limbs._cond_sub_p(spec, out)


def _sop_plain(spec: limbs.FieldSpec, a: torch.Tensor, b: torch.Tensor):
    """Schoolbook columns in int64 (no lo/hi split needed: a column holds at
    most T L (2^16 - 1)^2 < 2^40), then the 16-bit-digit reduction."""
    n = spec.n_limbs
    batch = torch.broadcast_shapes(a.shape[2:], b.shape[2:])
    a64, b64 = a.long(), b.long()
    prod = None
    for t in range(a.shape[0]):
        term = a64[t].unsqueeze(1) * b64[t].unsqueeze(0)  # [L, L, *batch]
        prod = term if prod is None else prod + term
    ids = limbs._const_tensor(
        tuple(i + j for i in range(n) for j in range(n)), a.device,
        torch.int64)
    cols = torch.zeros((2 * n + 1,) + batch, dtype=torch.int64,
                       device=a.device)
    cols.index_add_(0, ids, prod.reshape((n * n,) + batch))
    return _mont_reduce_plain(spec, cols).to(limbs.DTYPE)


def sop_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(sum_t a[t] b[t]) R^-1 mod p for int32 [T, 24, *batch] -> [24, *batch]."""
    return _sop_plain(limbs.FP, a, b)


def sop_fr_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(sum_t a[t] b[t]) R^-1 mod q for int32 [T, 16, *batch] -> [16, *batch]."""
    return _sop_plain(limbs.FR, a, b)


def sqr_plain(a: torch.Tensor) -> torch.Tensor:
    """G independent Montgomery squares, [G, L, *batch] -> [G, L, *batch]."""
    x = a.transpose(0, 1).unsqueeze(0)  # [1, L, G, *batch]
    return sop_plain(x, x).transpose(0, 1)


def fold_planned_plain(ops: torch.Tensor, ia, ib) -> torch.Tensor:
    """out[g] = (sum_t ops[ia[g, t]] ops[ib[g, t]]) R^-1 mod p for int32
    [K, 24, B] and [G, T] index tables -> [G, 24, B]: the rows gathered into
    [T, 24, G, B] and summed by `sop_plain`."""
    G, T = np.shape(ia)
    _, n, B = ops.shape

    def gather(idx):
        rows = torch.as_tensor(np.asarray(idx, np.int64).reshape(-1),
                               device=ops.device)
        return ops.index_select(0, rows).reshape(G, T, n, B).permute(
            1, 2, 0, 3)

    return sop_plain(gather(ia), gather(ib)).transpose(0, 1).contiguous()


def butterfly_plain(a: torch.Tensor, b: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """(a + b w, a - b w) mod q for int32 [16, *batch] x3 -> [2, 16, *batch]:
    the plain product, then the torch modular add and subtract."""
    t = sop_fr_plain(b.unsqueeze(0), w.unsqueeze(0))
    return torch.stack([limbs.add(limbs.FR, a, t), limbs.sub(limbs.FR, a, t)])


def pow_digits(exponent: int, modulus: int) -> np.ndarray:
    """The POW_WINDOW-bit digits of a nonnegative exponent, most significant
    first, as uint8: the JAX package's schedule (`limbs.pow_fixed`,
    limbs.py:707-716), the exponent zero-padded to the larger of its own and
    the modulus's bit width, rounded up to whole digits."""
    if not isinstance(exponent, int) or exponent < 0:
        raise ValueError(f"pow_fixed: exponent {exponent!r} is not an int "
                         ">= 0")
    width = max(exponent.bit_length(), modulus.bit_length())
    n = -(-width // POW_WINDOW)
    mask = (1 << POW_WINDOW) - 1
    return np.array([(exponent >> (POW_WINDOW * (n - 1 - i))) & mask
                     for i in range(n)], np.uint8)


def pow_fixed_plain(spec: limbs.FieldSpec, a: torch.Tensor,
                    exponent: int) -> torch.Tensor:
    """a^exponent for int32 [L, *batch] by the JAX package's schedule
    (limbs.py:693-735) over the plain products: the table (one, a and 14
    products), then per digit POW_WINDOW squarings and one product by the
    digit's entry, one for digit 0."""
    def mul(x, y):
        return _sop_plain(spec, x.unsqueeze(0), y.unsqueeze(0))

    one = limbs._col(spec.one_mont, a, limbs.DTYPE).expand(a.shape)
    table = [one, a]
    for _ in range(2, 1 << POW_WINDOW):
        table.append(mul(table[-1], a))
    acc = one
    for d in pow_digits(exponent, spec.modulus):
        for _ in range(POW_WINDOW):
            acc = mul(acc, acc)
        acc = mul(acc, table[d])
    return acc


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _sop_launch(fn, a, b, n_limbs, max_terms, name):
    """Validate and launch a [T, L, B] x2 -> [L, B] sum-of-products kernel;
    returns None for a CPU tensor (the caller runs the plain version)."""
    _check_limbs(a, f"{name} a", n_limbs)
    _check_pair(a, b, name)
    T, _, B = a.shape
    if not 1 <= T <= max_terms:
        raise ValueError(f"{name}: {T} terms; the kernel takes 1..{max_terms}")
    if device_kind(a) == "cpu":
        return None
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((n_limbs, B), dtype=limbs.DTYPE, device=a.device)
    if B == 0:
        return out
    with torch.cuda.device(a.device):
        rc = fn()(a.data_ptr(), b.data_ptr(), out.data_ptr(), T, B,
                  _stream(a))
        setattr(LAUNCHES, name, getattr(LAUNCHES, name) + 1)
    check_launch(rc, name)
    return out


def sop(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fused (sum_t a[t] b[t]) R^-1 mod p: int32 [T, 24, B] x2 -> [24, B]."""
    out = _sop_launch(lambda: _lib().bls_sop, a, b, L, MAX_TERMS, "sop")
    return sop_plain(a, b) if out is None else out


def sop_fr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fused (sum_t a[t] b[t]) R^-1 mod q: int32 [T, 16, B] x2 -> [16, B],
    T <= 2."""
    out = _sop_launch(lambda: _lib_fr().bls_sop_fr, a, b, L_FR, MAX_TERMS_FR,
                      "sop_fr")
    return sop_fr_plain(a, b) if out is None else out


def sqr(a: torch.Tensor) -> torch.Tensor:
    """G independent Montgomery squares: int32 [G, L, B] -> [G, L, B]."""
    _check_limbs(a, "sqr")
    G, _, B = a.shape
    if device_kind(a) == "cpu":
        return sqr_plain(a)
    a = a.contiguous()
    out = torch.empty_like(a)
    if G * B == 0:
        return out
    with torch.cuda.device(a.device):
        rc = _lib().bls_sqr(a.data_ptr(), out.data_ptr(), G, B, _stream(a))
        LAUNCHES.sqr += 1
    check_launch(rc, "sqr")
    return out


def fold_planned(ops: torch.Tensor, ia, ib) -> torch.Tensor:
    """G fused sums of products over a deduplicated operand stack:
    out[g] = (sum_t ops[ia[g, t]] ops[ib[g, t]]) R^-1 mod p.

    ops: int32 [K, 24, B] canonical limbs whose row 0 is zeros (padding
    terms index it); ia, ib: host int32 [G, T] tables (numpy arrays), T <= 8,
    G T <= FOLD_ENTRIES, entries in [0, K).  Returns int32 [G, 24, B]."""
    _check_limbs(ops, "fold_planned ops")
    ia = np.ascontiguousarray(ia, dtype=np.int32)
    ib = np.ascontiguousarray(ib, dtype=np.int32)
    K, _, B = ops.shape
    if ia.ndim != 2 or ia.shape != ib.shape:
        raise ValueError(f"fold_planned: index tables {ia.shape} and "
                         f"{ib.shape}; expected two equal [G, T]")
    G, T = ia.shape
    if not (1 <= T <= MAX_TERMS and G >= 1 and G * T <= FOLD_ENTRIES
            and K <= FOLD_OPERANDS):
        raise ValueError(f"fold_planned: G={G}, T={T}, K={K}; the kernel "
                         f"takes T <= {MAX_TERMS}, G T <= {FOLD_ENTRIES}, "
                         f"K <= {FOLD_OPERANDS}")
    if min(ia.min(), ib.min()) < 0 or max(ia.max(), ib.max()) >= K:
        raise ValueError(f"fold_planned: an index lies outside [0, {K})")
    if device_kind(ops) == "cpu":
        return fold_planned_plain(ops, ia, ib)
    ops = ops.contiguous()
    out = torch.empty((G, L, B), dtype=limbs.DTYPE, device=ops.device)
    if B == 0:
        return out
    with torch.cuda.device(ops.device):
        rc = _lib().bls_fold_planned(
            ops.data_ptr(), ia.ctypes.data, ib.ctypes.data, out.data_ptr(),
            K, G, T, B, _stream(ops))
        LAUNCHES.fold_planned += 1
    check_launch(rc, "fold_planned")
    return out


def butterfly(a: torch.Tensor, b: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """Fused NTT butterfly (a + b w, a - b w) mod q: int32 [16, B] x3 ->
    [2, 16, B] (lo, hi)."""
    for x, name in ((a, "a"), (b, "b"), (w, "w")):
        _check_limbs(x.unsqueeze(0), f"butterfly {name}", L_FR)
        _check_pair(a, x, "butterfly")
    if device_kind(a) == "cpu":
        return butterfly_plain(a, b, w)
    a, b, w = a.contiguous(), b.contiguous(), w.contiguous()
    B = a.shape[1]
    out = torch.empty((2, L_FR, B), dtype=limbs.DTYPE, device=a.device)
    if B == 0:
        return out
    with torch.cuda.device(a.device):
        rc = _lib_fr().bls_butterfly(a.data_ptr(), b.data_ptr(), w.data_ptr(),
                                     out.data_ptr(), B, _stream(a))
        LAUNCHES.butterfly += 1
    check_launch(rc, "butterfly")
    return out


def _pow_launch(fn, spec: limbs.FieldSpec, a: torch.Tensor, exponent: int,
                name: str):
    """Validate and launch a fixed-exponent power kernel on int32 [L, B];
    returns None for a CPU tensor (the caller runs the plain version)."""
    n = spec.n_limbs
    if a.dtype != limbs.DTYPE or a.dim() != 2 or a.shape[0] != n:
        raise ValueError(f"{name}: expected int32 [{n}, B], got "
                         f"{tuple(a.shape)} {a.dtype}")
    digits = pow_digits(exponent, spec.modulus)
    if len(digits) > POW_DIGITS:
        raise ValueError(f"{name}: a {exponent.bit_length()}-bit exponent; "
                         f"the kernel takes up to {POW_WINDOW * POW_DIGITS} "
                         "bits")
    if device_kind(a) == "cpu":
        return None
    a = a.contiguous()
    out = torch.empty_like(a)
    B = a.shape[1]
    if B == 0:
        return out
    with torch.cuda.device(a.device):
        rc = fn()(a.data_ptr(), out.data_ptr(), digits.ctypes.data,
                  len(digits), B, _stream(a))
        setattr(LAUNCHES, name, getattr(LAUNCHES, name) + 1)
    check_launch(rc, name)
    return out


def pow_fixed(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent in Montgomery form for a public exponent < 2^1024: int32
    [24, B] -> [24, B], the whole chain in one launch."""
    out = _pow_launch(lambda: _lib().bls_pow_fixed, limbs.FP, a, exponent,
                      "pow_fixed")
    return pow_fixed_plain(limbs.FP, a, exponent) if out is None else out


def pow_fixed_fr(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent mod q in Montgomery form for a public exponent < 2^1024:
    int32 [16, B] -> [16, B], the whole chain in one launch."""
    out = _pow_launch(lambda: _lib_fr().bls_pow_fixed_fr, limbs.FR, a,
                      exponent, "pow_fixed_fr")
    return pow_fixed_plain(limbs.FR, a, exponent) if out is None else out
