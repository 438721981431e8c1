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
"""

from __future__ import annotations

import dataclasses

from ..kernels import plan_exec as pe


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
