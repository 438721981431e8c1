"""Montgomery sums of products, squaring, the NTT butterfly and the
fixed-exponent power: CUDA kernels and plain versions.

`sop_rows` is the port's one sum-of-products kernel, built from
`csrc/montgomery.cuh`'s `sop_rows_kernel<F>` for Fp (`csrc/mont.cu`,
`bls_sop_rows`) and for Fr (`csrc/fr.cu`, `bls_sop_rows_fr`).  It replaces
`bls12_381_tpu/kernels/pallas_mont.py::sop_pallas` (Fp body
`_sop_kernel_r12_scalar`; the Fr route `_sop_kernel_reg`, chosen at
pallas_mont.py:682-689) and `fold_planned_pallas` (bodies
`_fold_planned_kernel_r12_scalar`, `_fold_planned_kernel_r12`).  `sop`,
`sop_fr` and `fold_planned` keep those kernels' signatures as thin adapters
whose rows are views into the caller's stacked tensor; `limbs.py` calls
`sop_rows` with its operands as they are.  `sqr` replaces `sqr_pallas`
(default body `_sqr_kernel_r12_scalar`; `csrc/mont_sqr.cuh`, built into
`csrc/mont.cu`), `butterfly`
replaces `butterfly_pallas` (bodies `_butterfly_kernel_16`,
`_butterfly_kernel_16_vec`, `csrc/fr.cu`).  `pow_fixed` (Fp, `csrc/mont.cu`)
and `pow_fixed_fr` (Fr, `csrc/fr.cu`) are `csrc/mont_pow.cuh`'s
`mont_pow_kernel<F, T, L>`: the JAX package's `limbs.pow_fixed`
(limbs.py:693, a scan of `sqr_pallas` and `sop_pallas` launches: 14 table
products, then 4 squares and a product per 4-bit digit) in one launch.
`fp2_pow_fixed` (`csrc/mont.cu`, `csrc/fp2_pow.cuh`'s `fp2_pow_kernel`)
does the same for the JAX package's `tower.fp2_pow` (tower.py:287, a scan
over the exponent's bits of fp2_sqr, fp2_mul and a select, whose Fp products
are `sop_pallas` launches): the Fp2 square roots' powers, one launch each,
on the same digit schedule with two threads per lane.  `sqr`'s kernel is
`mont_sqr.cuh`'s (one thread a lane, its additions in the hardware carry
flag: the off-diagonal products in two carry chains by column parity,
doubled by funnel shifts, the diagonal, then a Montgomery reduction in
carry chains and one conditional subtraction; SQR_THREADS threads a block,
SQR_LANES_PER_THREAD lanes a thread; its note gives the bound).

Design.  The 16-bit limbs of each operand are packed into 32-bit words in
registers (12 for Fp, 8 for Fr), a group's products are summed into a
2W+1-word accumulator with 32x32->64-bit multiply-adds, then one Montgomery
reduction with 32-bit digits (W rounds, m = t0 * (-p^-1 mod 2^32)) and one
conditional subtraction give the canonical result, unpacked to 16-bit
limbs.  The pre-reduction value is < T p^2, so the result is < T p^2/R + p,
which is < 2p while T p < R: R/p ~ 9.84 gives Fp T <= 8 (the JAX package's
chunk), R/q ~ 2.21 gives Fr T <= 2 (`limbs.FieldSpec.max_terms`).  The
canonical Montgomery value is unique for R, so the 32-bit digits cannot
change a result (`pallas_mont.py:96-105`).

`sop_rows` computes G sums out[g] = (sum_{t < n_g} rows[ia[g, t]]
rows[ib[g, t]]) R^-1 over a list of rows, each an operand [L, *b] that
broadcasts to the call's batch.  A row is passed as a device pointer and
three element strides (limb, outer lane, inner lane: lane l = o n + i with
n the size of the last batch axis), so a `movedim` view, a 0::2 slice, an
expanded operand (stride 0) or a constant is read where it lies.  Only a
row whose outer batch axes do not collapse to one stride is copied first;
each such row adds one to `LAUNCHES.copied_rows`.  The rows, the [G, T]
uint16 index tables and the uint8 term counts go by value in a
`__grid_constant__` struct, at the smallest of three capacities that holds
the call (16 rows and 16 entries: 496 bytes; 64 and 128: 2.2 KB; 1024 and
512: 27 KB, CUDA >= 12.1), so a product does not ship kilobytes of
parameters and no call copies a table to the device.  A block is a tile of
Lt lanes by gpb group slots by `split` threads per group
(`sop_launch_shape`): the groups of a call share the block, so a row that
several of them name comes from device memory once per tile and from L1
after that; at small widths the tile shrinks so that the blocks spread over
the SMs, and a group's terms spread over `split` threads whose partial
products meet in shared memory, so a thread's chain of dependent
multiply-adds is ceil(n_g / split) products long.

The butterfly is one Fr product t = b w R^-1 followed by a + t and a - t
mod q, all in registers; 2q < 2^256, so a + t never carries out of the 8
words.  The Fp and Fr power (`csrc/mont_pow.cuh`, whose note gives its
design) runs a lane's chain with the exponent's digits by value in the
launch's parameter block (uint8, up to POW_DIGITS) and the window table in
shared memory (16 x W words per lane, lane innermost); it skips the
leading zero digits and the products by entry 0 (R mod p), which leaves
every canonical value as the JAX schedule has it.  Its products are
carry-flag CIOS rows (the square at one thread a lane `mont_sqr.cuh`'s),
Fp values stay below 2p between steps (4p < R) and Fr values canonical
(4q > R), and a lane's product is split over T threads of a warp: T is
POW_TPI (4) for Fp and POW_TPI_FR (2) for Fr, halved until the launch's
threads fit POW_FILL_THREADS, 1 beyond (`pow_threads_per_lane`).  At p - 2
over 1024 lanes it takes 0.2384 ms (the earlier kernel, one thread a
lane and 64-bit carries: 0.5518), at 2^16 lanes 1.2849 (2.1762), and
q - 2 0.1144 (0.1901) (`scripts/pow_variants.py`, NVIDIA H100 80GB HBM3
at 700 W; PERF.md).  The Fp2 power is a
kernel of its own (`csrc/fp2_pow.cuh`, whose note gives its design): one
thread per coordinate, the two of a lane neighbours in a warp that swap
their coordinates by shuffles after each step, a Montgomery product whose
carries ride the hardware carry flag, reductions left lazy below 2p, and
FP2_POW_LANES lanes per block (the fastest of 32, 64 and 128 in
`scripts/fp2_pow_variants.py`; PERF.md): 0.5226 ms at (p-1)/2 at B = 1024
and 0.5223 at B = 1, where the Fp power template's own Fp2 instance, one
thread per lane, took 1.5185 (`chip_smoke.py`'s kernel table, NVIDIA
H100 80GB HBM3, 700 W).

Bound on the card.  A T = 1 Fp product reads 2 x 24 and writes 24 int32
words per lane (288 bytes) and does 2 x 12 x 12 word products plus the
reduction's 12 x 12 + 12, each a lo and a hi 32-bit multiply: about 600
IMADs per lane.  At 3.35 TB/s and 132 SMs x 64 IMAD/clock x 1.98 GHz the
bytes take ~2.4x longer than the multiplies, so T = 1 is bound by memory:
16-bit limbs stored in int32 double the bytes read.  Larger T moves toward
the multiply bound.  A fold's bound counts each distinct row read once and
G rows written.  At the paths' narrow widths (B = 1024) no launch comes
near either bound: its time is the launch and one thread's chain.  The
butterfly reads 3 x 64 and writes 2 x 64 bytes per lane (320 bytes) for
about 270 IMADs: bound by memory, ~50 us per NTT stage of 2^19 lanes.  A
power moves 2 L words per lane but runs ~480 dependent products (p - 2):
at B = 1024 its multiplies are ~14 us of the card's rate; one thread a
lane (32 warps) runs at the chain's latency (0.5518 ms), four threads a
lane (128 warps) at 16 times the multiplies (0.2384 ms), and at 2^16
lanes one thread a lane at 1.39 times its bound; the Fp2 power's
multiplies, its products counted at Karatsuba's three word products (~2.5
times as many per lane), are ~0.036 ms at B = 1024, and it runs at about 14
times that for the same reason, a pair of threads' chain (0.5226 ms; 1.38
times its bound at 2^16 lanes).  The kernels keep every
intermediate in registers or shared memory (nothing but the operands and
the result touches device memory); packing the boundary to 32-bit words
would halve their bytes and is left to a later change.

On a CPU tensor the wrappers run the plain versions below (int64 PyTorch
following the JAX jnp algorithms, `limbs.py:280-327`); on a CUDA tensor they
launch the kernel or raise.  Nothing sends a CUDA tensor to the plain path.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct

import numpy as np
import torch

from .. import limbs
from . import LAUNCHES, build

L = limbs.FP.n_limbs
L_FR = limbs.FR.n_limbs
MAX_TERMS = limbs.FP.max_terms
FOLD_ENTRIES = 512        # G T table entries of the largest capacity
SOP_ROWS = 1024           # rows of the largest capacity
SOP_THREADS = 256         # threads per block, at most (kSopRowsThreads)
SOP_MAX_TILE = 64         # lanes per block, at most
SOP_SPLIT_BELOW = 1 << 14  # lanes x groups below which a group's terms split
INT32_MAX = (1 << 31) - 1

# montgomery.cuh's SopRow: limb 0 of lane 0, then element strides
_ROW = struct.Struct("<Qiiii")

POW_WINDOW = 4            # bits per digit of pow_fixed (the JAX default)
POW_DIGITS = 256          # digits the pow kernel takes by value (1024 bits)
POW_TPI = 4               # threads per Fp lane of the pow kernel, at most
POW_TPI_FR = 2            # threads per Fr lane, at most
POW_LANES = 32            # lanes per block
POW_FILL_THREADS = 1 << 14  # threads a launch halves POW_TPI to fit
                            # (mont_pow.cuh kTpiFp, kTpiFr, kLanes,
                            # kFillThreads)
FP2_POW_LANES = 64        # lanes per block of fp2_pow_fixed, two threads
                          # each (fp2_pow.cuh's kLanes)
SQR_THREADS = 128         # threads per block of sqr (mont_sqr.cuh kThreads)
SQR_LANES_PER_THREAD = 1  # squares per thread (kLanesPerThread)

_POW_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p)
# (rows [host SopRow], n_rows, ia, ib [host uint16 G T], counts [host uint8
#  G], out, G, T, B, n_inner, lane tile, groups per block, split, stream)
_ROWS_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p) + (ctypes.c_int,) * 7 + (
              ctypes.c_void_p,)
_SIGNATURES = {
    "bls_sop_rows": _ROWS_ARGS,
    # (n_rows, entries)
    "bls_sop_rows_param_bytes": (ctypes.c_int, ctypes.c_int),
    # (a, out, G, B, stream)
    "bls_sqr": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p),
    # (a, out, digits [host uint8], n_digits, B, stream)
    "bls_pow_fixed": _POW_ARGS,
    # (a0, a1, out0, out1, digits [host uint8], n_digits, B, stream)
    "bls_fp2_pow_fixed": (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 2 + (
        ctypes.c_void_p,),
}
_SIGNATURES_FR = {
    "bls_sop_rows_fr": _ROWS_ARGS,
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


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def as_batch(x: torch.Tensor, full) -> torch.Tensor:
    """A row [L, *b] as a view of shape full = (L, *batch), its batch axes
    aligned with the batch's last ones (broadcast as `torch.broadcast_shapes`
    of the batch shapes aligns them)."""
    lead = (1,) * (len(full) - x.dim())
    return x.reshape((x.shape[0],) + lead + tuple(x.shape[1:])).expand(full)


def sop_rows_plain(spec: limbs.FieldSpec, rows, ia, ib, counts,
                   batch) -> torch.Tensor:
    """out[g] = (sum_{t < counts[g]} rows[ia[g, t]] rows[ib[g, t]]) R^-1 mod
    m -> int32 [G, L, *batch]: each group's rows gathered into
    [T, L, G, *batch], its missing terms zero, and summed by `_sop_plain`."""
    full = (spec.n_limbs,) + tuple(batch)
    G, T = np.shape(ia)
    zero = torch.zeros(full, dtype=limbs.DTYPE, device=rows[0].device)

    def gather(idx):
        return torch.stack([torch.stack(
            [as_batch(rows[idx[g][t]], full) if t < counts[g] else zero
             for g in range(G)], dim=1) for t in range(T)])

    return _sop_plain(spec, gather(ia), gather(ib)).movedim(1, 0) \
        .contiguous()


def fold_planned_plain(ops: torch.Tensor, ia, ib) -> torch.Tensor:
    """out[g] = (sum_t ops[ia[g, t]] ops[ib[g, t]]) R^-1 mod p for int32
    [K, 24, B] and [G, T] index tables -> [G, 24, B]."""
    G, T = np.shape(ia)
    return sop_rows_plain(limbs.FP, list(ops.unbind(0)), ia, ib, [T] * G,
                          ops.shape[2:])


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


def fp2_pow_plain(a0: torch.Tensor, a1: torch.Tensor,
                  exponent: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(a0 + a1 u)^exponent in Fp2 for int32 [24, *batch] x2 by the JAX
    package's bit schedule (`tower.fp2_pow`, tower.py:287-309): from one,
    per bit of the exponent, zero-padded to at least p's 381 bits, a square
    and then the product by a where the bit is set (the JAX select by the
    static bit keeps the product exactly there).  Both halves of a square,
    (a0 + a1)(a0 - a1) and a0 a1 + a0 a1, and of a product, a0 b0 + a1 (-b1)
    and a0 b1 + a1 b0, are one `_sop_plain` call over a stacked axis."""
    if not isinstance(exponent, int) or exponent < 0:
        raise ValueError(f"fp2_pow: exponent {exponent!r} is not an int "
                         ">= 0")
    spec = limbs.FP
    zero = torch.zeros_like(a0)
    nb1 = limbs.neg(spec, a1)

    def sums(terms):
        """[(x0, y0, x1, y1), ...] terms -> (sum x0 y0, sum x1 y1)."""
        x = torch.stack([torch.stack([t[0], t[2]], 1) for t in terms])
        y = torch.stack([torch.stack([t[1], t[3]], 1) for t in terms])
        return _sop_plain(spec, x, y).unbind(1)  # [T, 24, 2, *batch]

    c0 = limbs._col(spec.one_mont, a0, limbs.DTYPE).expand(a0.shape)
    c1 = zero
    width = max(exponent.bit_length(), spec.modulus.bit_length())
    for i in range(width - 1, -1, -1):
        s, d = limbs.add(spec, c0, c1), limbs.sub(spec, c0, c1)
        c0, c1 = sums([(s, d, c0, c1), (zero, zero, c0, c1)])
        if (exponent >> i) & 1:
            c0, c1 = sums([(c0, a0, c0, a1), (c1, nb1, c1, a0)])
    return c0, c1


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def row_strides(x: torch.Tensor, batch):
    """(s_limb, s_outer, s_inner) element strides of a row x [L, *b]
    broadcast to (L, *batch) (b aligned with the batch's last axes), lane
    l = o n + i over the flattened batch (n its last axis), read from x's
    own sizes and strides; None when its outer batch axes do not collapse
    to one stride.  Raises ValueError when x does not broadcast."""
    shape, st = x.shape, x.stride()
    k, nb = len(shape) - 1, len(batch)
    if k > nb or any(n != 1 and n != m
                     for n, m in zip(shape[1:], batch[nb - k:])):
        raise ValueError(f"sop_rows: a row {tuple(shape)} does not "
                         f"broadcast to the batch {tuple(batch)}")
    strides = [0] * (nb - k) + [s if n != 1 else 0
                                for n, s in zip(shape[1:], st[1:])]
    if nb == 0:
        return st[0], 0, 0
    s_outer, expect = 0, None
    for d in range(nb - 2, -1, -1):  # outer axes, innermost first
        if batch[d] == 1:
            continue
        if expect is None:
            s_outer = strides[d]
        elif strides[d] != expect:
            return None
        expect = strides[d] * batch[d]
    return st[0], s_outer, strides[-1] if batch[-1] > 1 else 0


def _tables(ia, ib, counts, max_terms: int, n_rows: int):
    """(G, T, ia, ib, counts) of host tables as Python ints, the [G, T]
    tables flattened with the entries past a group's count set to 0;
    raises ValueError on what the kernel does not take."""
    ia, ib, counts = (x.tolist() if isinstance(x, np.ndarray) else x
                      for x in (ia, ib, counts))
    try:
        ia = [[int(v) for v in r] for r in ia]
        ib = [[int(v) for v in r] for r in ib]
        counts = [int(c) for c in counts]
    except TypeError:
        raise ValueError("sop_rows: expected [G, T] tables and [G] counts")
    G, T = len(ia), len(ia[0]) if ia else 0
    if len(ib) != G or len(counts) != G or any(
            len(r) != T for r in ia + ib):
        raise ValueError("sop_rows: expected two [G, T] tables and [G] "
                         "counts of one G")
    if not (G >= 1 and 1 <= T <= max_terms and G * T <= FOLD_ENTRIES
            and 1 <= n_rows <= SOP_ROWS):
        raise ValueError(f"sop_rows: G={G}, T={T}, {n_rows} rows; the "
                         f"kernel takes T <= {max_terms}, G T <= "
                         f"{FOLD_ENTRIES}, 1..{SOP_ROWS} rows")
    fa, fb = [0] * (G * T), [0] * (G * T)
    for g, n in enumerate(counts):
        if not 1 <= n <= T:
            raise ValueError(f"sop_rows: a term count outside 1..{T}")
        for t in range(n):
            a, b = ia[g][t], ib[g][t]
            if not (0 <= a < n_rows and 0 <= b < n_rows):
                raise ValueError(f"sop_rows: an index lies outside "
                                 f"[0, {n_rows})")
            fa[g * T + t], fb[g * T + t] = a, b
    return G, T, fa, fb, counts


def sop_launch_shape(G: int, T: int, B: int, n_sm: int, split=None):
    """(lane tile Lt, group slots per block, threads per group) of a
    launch over B lanes.  A group's terms split over T threads while the
    call has fewer than SOP_SPLIT_BELOW (lane, group) pairs.  (On the H100
    at B = 1024 the split took the pairing's 31 folds from 0.0088 to
    0.0063 ms per launch, a 6-group, 6-term fold from 0.0096 to 0.0070 ms
    and the pairing's norm from 0.0046 to 0.0037 ms; 4 groups of 6 terms
    over 4096 lanes ran 6 % slower split, hence the threshold; PERF.md.)
    Lt is the largest power of two <= SOP_MAX_TILE that still gives
    every SM a block (one lane where nothing wider does); the group slots
    fill the block up to SOP_THREADS threads, and a call of more groups
    takes them in rounds within the block."""
    if split is None:
        split = T if B * G < SOP_SPLIT_BELOW else 1
    lt = SOP_MAX_TILE
    while lt > 1 and (-(-B // lt) < n_sm or lt * split > SOP_THREADS):
        lt //= 2
    return lt, max(1, min(G, SOP_THREADS // (lt * split))), split


def sop_rows_param_bytes(n_rows: int, entries: int) -> int:
    """Parameter bytes of the capacity a call of n_rows rows and `entries`
    table entries launches with (the kernel's own sizeof)."""
    return _lib().bls_sop_rows_param_bytes(n_rows, entries)


def sop_rows(spec: limbs.FieldSpec, rows, ia, ib, counts, batch,
             shape=None) -> torch.Tensor:
    """G fused sums of products over operands read where they lie:
    out[g] = (sum_{t < counts[g]} rows[ia[g, t]] rows[ib[g, t]]) R^-1 mod m.

    rows: int32 [L, *b] canonical limbs (any strides), each broadcasting to
    `batch`; ia, ib: host [G, T] index tables, T <= spec.max_terms, G T <=
    FOLD_ENTRIES (entries past a group's count are not read); counts: host
    [G] term counts in 1..T; at most SOP_ROWS rows.  shape: (lane tile,
    group slots, split) instead of `sop_launch_shape`'s.  Returns int32
    [G, L, *batch].  Counts one launch of `sop_fr` (Fr), `sop` (Fp, one
    group) or `fold_planned` (Fp, G >= 2).  The host work per call is
    plain Python over sizes and strides (no tensor op but the output's
    allocation), since the paths that call it are bound by the host."""
    n = spec.n_limbs
    G, T, fa, fb, counts = _tables(ia, ib, counts, spec.max_terms,
                                   len(rows))
    dev = rows[0].device
    for x in rows:
        if x.dtype != limbs.DTYPE or x.dim() < 1 or x.shape[0] != n \
                or x.device != dev:
            raise ValueError(f"sop_rows: a row {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}; expected int32 [{n}, ...] on "
                             f"{dev}")
    kind = device_kind(rows[0])
    batch = tuple(int(d) for d in batch)
    layouts = [row_strides(x, batch) for x in rows]
    copied = [k for k, lay in enumerate(layouts) if lay is None]
    LAUNCHES.copied_rows += len(copied)
    if kind == "cpu":
        return sop_rows_plain(spec, rows, ia, ib, counts, batch)
    full = (n,) + batch
    rows = list(rows)
    for k in copied:  # no two affine lane strides: the one copy
        rows[k] = as_batch(rows[k], full).contiguous()
        layouts[k] = row_strides(rows[k], batch)
    B = math.prod(batch)
    out = torch.empty((G,) + full, dtype=limbs.DTYPE, device=dev)
    if B == 0:
        return out
    if B > INT32_MAX or max(max(lay) for lay in layouts) > INT32_MAX:
        raise ValueError("sop_rows: a lane count or stride beyond int32")
    lt, gpb, split = shape or sop_launch_shape(G, T, B, sm_count(dev.index))
    table = b"".join(_ROW.pack(x.data_ptr(), *lay, 0)
                     for x, lay in zip(rows, layouts))
    fr = n == L_FR
    lib = _lib_fr().bls_sop_rows_fr if fr else _lib().bls_sop_rows
    counter = "sop_fr" if fr else "sop" if G == 1 else "fold_planned"
    with torch.cuda.device(dev):
        rc = lib(table, len(rows), struct.pack(f"<{G * T}H", *fa),
                 struct.pack(f"<{G * T}H", *fb), bytes(counts),
                 out.data_ptr(), G, T, B, batch[-1] if batch else 1, lt, gpb,
                 split, _stream(out))
        setattr(LAUNCHES, counter, getattr(LAUNCHES, counter) + 1)
    check_launch(rc, f"sop_rows ({counter})")
    return out


def _sop_pair(spec: limbs.FieldSpec, a, b, name: str) -> torch.Tensor:
    """[T, L, B] x2 -> [L, B] through `sop_rows`, rows a[t] and b[t]."""
    _check_limbs(a, f"{name} a", spec.n_limbs)
    _check_pair(a, b, name)
    T, _, B = a.shape
    if not 1 <= T <= spec.max_terms:
        raise ValueError(f"{name}: {T} terms; the kernel takes "
                         f"1..{spec.max_terms}")
    ia = np.arange(T).reshape(1, T)
    return sop_rows(spec, list(a.unbind(0)) + list(b.unbind(0)), ia, ia + T,
                    [T], (B,))[0]


def sop(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fused (sum_t a[t] b[t]) R^-1 mod p: int32 [T, 24, B] x2 -> [24, B]."""
    return _sop_pair(limbs.FP, a, b, "sop")


def sop_fr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fused (sum_t a[t] b[t]) R^-1 mod q: int32 [T, 16, B] x2 -> [16, B],
    T <= 2."""
    return _sop_pair(limbs.FR, a, b, "sop_fr")


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
    out[g] = (sum_t ops[ia[g, t]] ops[ib[g, t]]) R^-1 mod p, every one of
    the T terms (short groups index a zero row).

    ops: int32 [K, 24, B] canonical limbs; ia, ib: host [G, T] tables, T <=
    8, G T <= FOLD_ENTRIES, entries in [0, K).  Returns int32 [G, 24, B]
    through `sop_rows`, whose rows are the stack rows the tables name."""
    _check_limbs(ops, "fold_planned ops")
    ia, ib = np.asarray(ia), np.asarray(ib)
    K, _, B = ops.shape
    if ia.ndim != 2 or ia.shape != ib.shape:
        raise ValueError(f"fold_planned: index tables {ia.shape} and "
                         f"{ib.shape}; expected two equal [G, T]")
    G, T = ia.shape
    if not (1 <= T <= MAX_TERMS and G >= 1 and G * T <= FOLD_ENTRIES):
        raise ValueError(f"fold_planned: G={G}, T={T}; the kernel takes "
                         f"T <= {MAX_TERMS}, G T <= {FOLD_ENTRIES}")
    if min(ia.min(), ib.min()) < 0 or max(ia.max(), ib.max()) >= K:
        raise ValueError(f"fold_planned: an index lies outside [0, {K})")
    used, idx = np.unique(np.concatenate([ia.ravel(), ib.ravel()]),
                          return_inverse=True)
    idx = idx.reshape(2, G, T)
    return sop_rows(limbs.FP, [ops[k] for k in used], idx[0], idx[1],
                    np.full(G, T), (B,))


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


def pow_threads_per_lane(spec: limbs.FieldSpec, B: int) -> int:
    """The threads per lane of a `pow_fixed` (Fp) or `pow_fixed_fr` (Fr)
    launch over B lanes, as `mont_pow.cuh`'s `launch_pow` picks them: the
    field's POW_TPI or POW_TPI_FR, halved until B of them fit
    POW_FILL_THREADS, at least 1."""
    t = POW_TPI if spec is limbs.FP else POW_TPI_FR
    while t > 1 and B * t > POW_FILL_THREADS:
        t //= 2
    return t


def _pow_launch(fn, spec: limbs.FieldSpec, operands, exponent: int,
                name: str):
    """Validate the components (one for Fp or Fr, two for Fp2), each int32
    [L, B] on one device, and launch a fixed-exponent power kernel:
    returns [components, L, B], or None for CPU tensors (the caller runs
    the plain version)."""
    n = spec.n_limbs
    for a in operands:
        if a.dtype != limbs.DTYPE or a.dim() != 2 or a.shape[0] != n:
            raise ValueError(f"{name}: expected int32 [{n}, B], got "
                             f"{tuple(a.shape)} {a.dtype}")
        _check_pair(operands[0], a, name)
    digits = pow_digits(exponent, spec.modulus)
    if len(digits) > POW_DIGITS:
        raise ValueError(f"{name}: a {exponent.bit_length()}-bit exponent; "
                         f"the kernel takes up to {POW_WINDOW * POW_DIGITS} "
                         "bits")
    if device_kind(operands[0]) == "cpu":
        return None
    operands = [a.contiguous() for a in operands]
    B = operands[0].shape[1]
    out = torch.empty((len(operands), n, B), dtype=limbs.DTYPE,
                      device=operands[0].device)
    if B == 0:
        return out
    with torch.cuda.device(out.device):
        rc = fn()(*(a.data_ptr() for a in operands),
                  *(o.data_ptr() for o in out), digits.ctypes.data,
                  len(digits), B, _stream(out))
        setattr(LAUNCHES, name, getattr(LAUNCHES, name) + 1)
    check_launch(rc, name)
    return out


def pow_fixed(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent in Montgomery form for a public exponent < 2^1024: int32
    [24, B] -> [24, B], the whole chain in one launch."""
    out = _pow_launch(lambda: _lib().bls_pow_fixed, limbs.FP, [a], exponent,
                      "pow_fixed")
    return pow_fixed_plain(limbs.FP, a, exponent) if out is None else out[0]


def fp2_pow_fixed(a0: torch.Tensor, a1: torch.Tensor, exponent: int):
    """(a0 + a1 u)^exponent in Fp2, Montgomery form, for a public exponent
    < 2^1024: int32 [24, B] x2 -> (c0, c1), the whole chain in one launch
    of `fp2_pow_kernel` (the JAX package's `tower.fp2_pow`, a scan of
    sop_pallas launches, tower.py:287)."""
    out = _pow_launch(lambda: _lib().bls_fp2_pow_fixed, limbs.FP, [a0, a1],
                      exponent, "fp2_pow_fixed")
    if out is None:
        return fp2_pow_plain(a0, a1, exponent)
    return out[0], out[1]


def pow_fixed_fr(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent mod q in Montgomery form for a public exponent < 2^1024:
    int32 [16, B] -> [16, B], the whole chain in one launch."""
    out = _pow_launch(lambda: _lib_fr().bls_pow_fixed_fr, limbs.FR, [a],
                      exponent, "pow_fixed_fr")
    return pow_fixed_plain(limbs.FR, a, exponent) if out is None else out[0]
