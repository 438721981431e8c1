"""Host-side integer arithmetic the port needs: Fp/Fp2 on Python ints.

A small subset of the reference package's pure-Python oracle.  It computes
the Frobenius and endomorphism coefficients that `fields/tower.py`,
`curves/g1.py` and `curves/g2.py` embed as constants, and the affine group
law (add, neg, scalar multiple; None is the point at infinity) that the
entry points and the checks use.  Tests hold the port against the full
oracle; nothing here is on the device path.
"""

from __future__ import annotations

from .params import B_G1, B_G2, BLS_X, G1_GEN, P, Q

# --- Fp2 = Fp[u]/(u^2 + 1); elements are (c0, c1) ------------------------

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)


def fp_inv(a):
    if a % P == 0:
        raise ZeroDivisionError("inversion of zero in Fp")
    return pow(a, P - 2, P)


def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % P, (a0 * b1 + a1 * b0) % P)


def fp2_square(a):
    a0, a1 = a
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def fp2_inv(a):
    a0, a1 = a
    ninv = fp_inv((a0 * a0 + a1 * a1) % P)
    return (a0 * ninv % P, (-a1) * ninv % P)


def fp2_conjugate(a):
    return (a[0], (-a[1]) % P)


def fp2_pow(a, e):
    result = FP2_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fp2_mul(result, base)
        base = fp2_square(base)
        e >>= 1
    return result


# --- Frobenius coefficients (computed, not transcribed) -------------------

XI = (1, 1)  # u + 1, the Fp6 nonresidue

# gamma_6[i] = xi^(i (p - 1) / 3) for the Fp6 Frobenius; gamma_12 = xi^((p - 1) / 6)
FROB6_C1 = fp2_pow(XI, (P - 1) // 3)
FROB6_C2 = fp2_pow(XI, 2 * (P - 1) // 3)
FROB12_C1 = fp2_pow(XI, (P - 1) // 6)


# --- affine group law (vartime; example inputs and checks only) -----------


class _Curve:
    """y^2 = x^3 + b over a field given by its operations; None is the
    point at infinity."""

    def __init__(self, add, sub, mul, inv, b, zero):
        self.add, self.sub, self.mul, self.inv = add, sub, mul, inv
        self.b, self.zero = b, zero

    def neg(self, pt):
        return None if pt is None else (pt[0], self.sub(self.zero, pt[1]))

    def double(self, pt):
        if pt is None or pt[1] == self.zero:
            return None
        x, y = pt
        xx = self.mul(x, x)
        lam = self.mul(self.add(self.add(xx, xx), xx), self.inv(self.add(y, y)))
        x3 = self.sub(self.mul(lam, lam), self.add(x, x))
        return (x3, self.sub(self.mul(lam, self.sub(x, x3)), y))

    def add_points(self, p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        (x1, y1), (x2, y2) = p1, p2
        if x1 == x2:
            return self.double(p1) if y1 == y2 else None
        lam = self.mul(self.sub(y2, y1), self.inv(self.sub(x2, x1)))
        x3 = self.sub(self.sub(self.mul(lam, lam), x1), x2)
        return (x3, self.sub(self.mul(lam, self.sub(x1, x3)), y1))

    def scalar_mul(self, pt, k):
        acc = None
        for bit in bin(k)[2:] if k > 0 else "":
            acc = self.double(acc)
            if bit == "1":
                acc = self.add_points(acc, pt)
        return acc


_G1 = _Curve(lambda a, b: (a + b) % P, lambda a, b: (a - b) % P,
             lambda a, b: a * b % P, fp_inv, B_G1, 0)
_G2 = _Curve(fp2_add, fp2_sub, fp2_mul, fp2_inv, B_G2, FP2_ZERO)

g1_add, g1_neg, g1_mul = _G1.add_points, _G1.neg, _G1.scalar_mul
g2_add, g2_neg, g2_mul = _G2.add_points, _G2.neg, _G2.scalar_mul


# --- endomorphism constants (computed, not transcribed) -------------------


def _compute_beta():
    """The cube root of unity beta of Fp with phi(x, y) = (beta x, y) equal
    to -[z^2] on G1 (g1.rs:421-437)."""
    for e in (1, 2):
        beta = pow(2, e * (P - 1) // 3, P)  # 2 is a non-cube in Fp*
        if (beta * G1_GEN[0] % P, G1_GEN[1]) == g1_neg(
                g1_mul(G1_GEN, BLS_X * BLS_X % Q)):
            return beta
    raise AssertionError("no cube root of unity acts as -z^2")


G1_BETA = _compute_beta()

# psi(x, y) = (c_x conj(x), c_y conj(y)) with c_x = 1/xi^((p-1)/3),
# c_y = 1/xi^((p-1)/2) (g2.rs:847-888)
PSI_CX = fp2_inv(fp2_pow(XI, (P - 1) // 3))
PSI_CY = fp2_inv(fp2_pow(XI, (P - 1) // 2))
