"""Batched short-Weierstrass group law (y^2 = x^3 + b, a = 0), generic over
the field: Fp for G1, Fp2 for G2.  Counterpart of
`bls12_381_tpu/curves/weierstrass.py`.

Points are tuples of field elements: projective (x, y, z), affine
(x, y, inf_mask).  Addition, doubling and mixed addition are the complete
Renes-Costello-Batina formulas (ePrint 2015/1060 Algorithms 7, 8, 9), the
reference's choice (g1.rs:638/670/715), and each runs as ONE expression plan
(`kernels/plan_exec.py`): the plan kernel on a CUDA tensor, its plain
version on a CPU tensor.  The plans compute the same canonical values as the
JAX package's staged formulas, so points equal its points limb for limb.

The scalar multiplications keep the JAX package's schedules (the start from
the identity, the order of the table's adds, the zero padding of digit
lists), so their projective results equal its results too.  Their table
lookups only select, so one gather per table stands in for the JAX
package's masked-select trees.
"""

from __future__ import annotations

import dataclasses

from ..kernels import plan_exec as pe
from ..utils import scans


@dataclasses.dataclass(frozen=True)
class FieldFns:
    """The field interface the group law needs."""

    add: callable
    neg: callable
    mul: callable
    mul_many: callable  # [(a, b), ...] -> [ab, ...] in one fold
    select: callable    # (mask, a, b) -> a where mask else b
    eq: callable
    is_zero: callable
    zero: callable      # (batch, device) -> element
    one: callable       # (batch, device) -> element
    b: callable         # (batch, device) -> the curve constant b
    batch_of: callable  # element -> batch shape
    device_of: callable
    rows: callable      # element -> its Fp rows, in a plan's operand order
    from_rows: callable  # Fp rows -> element
    add_plan: callable  # plan constructors (kernels/plan_exec.py)
    double_plan: callable
    add_mixed_plan: callable


class Weierstrass:
    def __init__(self, f: FieldFns):
        self.f = f

    # -- constructors ------------------------------------------------------

    def identity(self, batch=(), device="cuda"):
        f = self.f
        return (f.zero(batch, device), f.one(batch, device),
                f.zero(batch, device))

    def from_affine(self, aff):
        """(x, y, inf) -> projective; the identity maps to (0 : 1 : 0)."""
        f = self.f
        x, y, inf = aff
        zero, one = (fn(f.batch_of(x), f.device_of(x))
                     for fn in (f.zero, f.one))
        return (f.select(inf, zero, x), f.select(inf, one, y),
                f.select(inf, zero, one))

    # -- predicates --------------------------------------------------------

    def is_identity(self, p):
        return self.f.is_zero(p[2])

    def is_on_curve(self, p):
        """y^2 z == x^3 + b z^3, or z == 0 (g1.rs:414-417)."""
        f = self.f
        x, y, z = p
        y2, x2, z2 = f.mul_many([(y, y), (x, x), (z, z)])
        lhs, x3, z3 = f.mul_many([(y2, z), (x2, x), (z2, z)])
        rhs = f.add(x3, f.mul(f.b(f.batch_of(x), f.device_of(x)), z3))
        return f.eq(lhs, rhs) | f.is_zero(z)

    def eq(self, p, q):
        """Projective equality x1 z2 == x2 z1 and y1 z2 == y2 z1, with two
        identities equal and an identity unequal to any other point."""
        f = self.f
        x1, y1, z1 = p
        x2, y2, z2 = q
        both_inf = f.is_zero(z1) & f.is_zero(z2)
        one_inf = f.is_zero(z1) ^ f.is_zero(z2)
        a, b, c, d = f.mul_many([(x1, z2), (x2, z1), (y1, z2), (y2, z1)])
        return both_inf | (f.eq(a, b) & f.eq(c, d) & ~one_inf)

    def neg(self, p):
        return (p[0], self.f.neg(p[1]), p[2])

    # -- group law: one plan launch each -------------------------------------

    def _run(self, plan, coords):
        f = self.f
        out = pe.run_plan(plan(), [r for c in coords for r in f.rows(c)])
        n = len(out) // 3
        return tuple(f.from_rows(out[i * n:(i + 1) * n]) for i in range(3))

    def double(self, p):
        """Algorithm 9 (a = 0)."""
        return self._run(self.f.double_plan, p)

    def add(self, p, q):
        """Algorithm 7 (a = 0), complete for all inputs."""
        return self._run(self.f.add_plan, tuple(p) + tuple(q))

    def add_mixed(self, p, aff):
        """Algorithm 8 (a = 0, z2 = 1); an affine identity returns p
        (g1.rs:715-751), selected outside the kernel."""
        f = self.f
        x2, y2, inf2 = aff
        out = self._run(f.add_mixed_plan, tuple(p) + (x2, y2))
        return tuple(f.select(inf2, a, b) for a, b in zip(p, out))

    # -- scalar multiplication ----------------------------------------------

    def scalar_mul_bits(self, p, bits):
        """Double-and-add over a [n_bits, *batch] bool tensor, MSB first,
        from the identity (g1.rs:754-774): every bit doubles, adds P and
        selects."""
        f = self.f
        acc = self.identity(f.batch_of(p[0]), f.device_of(p[0]))
        for bit in bits:
            acc = self.double(acc)
            added = self.add(acc, p)
            acc = tuple(f.select(bit, a, b) for a, b in zip(added, acc))
        return acc

    def scalar_mul_windowed(self, p, digits, window: int = 4):
        """Fixed windows over [n_digits, *batch] digits in [0, 2^window),
        MSB first: a 2^window-entry table, then per digit `window` doublings
        and one add of the digit's entry (digit 0 adds the identity)."""
        return self.multi_scalar_mul_windowed([p], [digits], window)

    def multi_scalar_mul_windowed(self, points, digits_list, window: int = 4):
        """sum_i [k_i] P_i with shared doublings (Straus windows): one pass
        over the digit steps, each `window` doublings and one table add per
        point.  Shorter digit lists are left-padded with zero digits."""
        return self._straus(points, [(d, None) for d in digits_list],
                            1 << window, window)

    def multi_scalar_mul_signed(self, points, signed_digits_list,
                                window: int = 4):
        """sum_i [k_i] P_i with shared doublings over balanced digits
        (`limbs.signed_digits_msb`: (mags, negs) per point, MSB first,
        magnitudes in [0, 2^(window-1)]): tables of identity, P, ...,
        2^(window-1) P, and a masked y-negate of the entry for a negative
        digit.  The JAX package's default "tree" lookup selects the same
        entries."""
        return self._straus(points, signed_digits_list,
                            (1 << (window - 1)) + 1, window)

    def _straus(self, points, digits_list, n_entries: int, window: int):
        """`scans.straus` in this group: `window` doublings per step, the
        masked y-negate of a negative digit's entry."""
        f = self.f
        batch, dev = f.batch_of(points[0][0]), f.device_of(points[0][0])

        def double_window(acc):
            for _ in range(window):
                acc = self.double(acc)
            return acc

        def neg_select(neg, e):
            # (0 : -1 : 0) is still the identity class
            return (e[0], f.select(neg, f.neg(e[1]), e[1]), e[2])

        return scans.straus(points, digits_list, n_entries,
                            lambda: self.identity(batch, dev), self.add,
                            double_window, neg_select)

    def mul_by_const(self, p, k: int, n_bits: int | None = None):
        """[k]P for a static public integer (the mul_by_x analog,
        g1.rs:777-795): from the identity, a doubling per bit of |k|
        (n_bits of them, the top one first) and an add of P at each set
        bit.  The JAX scan adds at every bit and keeps the accumulator at a
        zero bit; the values are the same.  A negative k negates."""
        f = self.f
        kk = abs(k)
        nb = n_bits or kk.bit_length()
        acc = self.identity(f.batch_of(p[0]), f.device_of(p[0]))
        for i in range(nb - 1, -1, -1):
            acc = self.double(acc)
            if (kk >> i) & 1:
                acc = self.add(acc, p)
        return self.neg(acc) if k < 0 else acc

    # -- normalization -------------------------------------------------------

    def to_affine(self, p, inv_fn):
        """Projective -> affine (x, y, inf); z = 0 inverts to 0 and the
        identity decodes to (0, 1, True) like G1Affine::identity()."""
        f = self.f
        x, y, z = p
        inf = f.is_zero(z)
        zinv = inv_fn(z)
        ax, ay = f.mul_many([(x, zinv), (y, zinv)])
        batch, dev = f.batch_of(x), f.device_of(x)
        return (f.select(inf, f.zero(batch, dev), ax),
                f.select(inf, f.one(batch, dev), ay), inf)
