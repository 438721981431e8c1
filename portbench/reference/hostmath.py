"""Host-side integer arithmetic: Fp up to Fp12, Fr and the curves on
Python ints.

A frozen copy of `bls12_381_torch/hostmath.py` (itself a copy of the JAX
package's pure-Python oracle), kept with the benchmark so that a change to
the program cannot move the yardstick.  It is the plain reference of the
benchmark's checks: the affine group law (None is the point at infinity),
the byte codecs with their subgroup checks, expand_message_xmd by hashlib,
hash to curve (SSWU and the isogenies on ints), the Miller loop and the
final exponentiation.  It imports the standard library and `params.py`
beside it, and nothing of the program.
"""

from __future__ import annotations

import functools
import hashlib

from .params import (B_G1, B_G2, BLS_X, BLS_X_IS_NEGATIVE, G1_GEN, G2_GEN,
                     H_EFF_G1, H_EFF_G2, ISO_CONSTS, P, Q)

# --- Fp ---------------------------------------------------------------------


def fp_add(a, b):
    return (a + b) % P


def fp_sub(a, b):
    return (a - b) % P


def fp_neg(a):
    return (-a) % P


def fp_mul(a, b):
    return (a * b) % P


def fp_inv(a):
    """a^-1 mod p by Python's extended Euclid (the copy's a^(p-2), the
    same value, took two thirds of a verify's time)."""
    if a % P == 0:
        raise ZeroDivisionError("inversion of zero in Fp")
    return pow(a, -1, P)


def fp_sqrt(a):
    """A square root in Fp (p = 3 mod 4: the candidate a^((p+1)/4)); None
    for a non-square."""
    c = pow(a, (P + 1) // 4, P)
    return c if c * c % P == a % P else None


def fp_sgn0(a):
    return a % P & 1


# --- Fp2 = Fp[u]/(u^2 + 1); elements are (c0, c1) ------------------------

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)


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


def fp2_mul_fp(a, s):
    return (a[0] * s % P, a[1] * s % P)


def fp2_mul_by_nonresidue(a):
    """Multiply by u + 1 (fp2.rs:156-166)."""
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def fp2_conjugate(a):
    return (a[0], (-a[1]) % P)


def fp2_is_zero(a):
    return a[0] % P == 0 and a[1] % P == 0


def fp2_sgn0(a):
    """sgn0 for m = 2 (draft-16 §4.1, map_g2.rs:381-388)."""
    s0, z0, s1 = a[0] % P & 1, a[0] % P == 0, a[1] % P & 1
    return s0 | (z0 & s1)


def fp2_pow(a, e):
    result = FP2_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fp2_mul(result, base)
        base = fp2_square(base)
        e >>= 1
    return result


def fp2_sqrt(a):
    """A square root in Fp2 (any root; ePrint 2012/685 Alg. 9 shape), None
    for a non-square."""
    a = (a[0] % P, a[1] % P)
    if fp2_is_zero(a):
        return FP2_ZERO
    a1 = fp2_pow(a, (P - 3) // 4)
    alpha = fp2_mul(fp2_square(a1), a)
    x0 = fp2_mul(a1, a)
    if alpha == (P - 1, 0):
        cand = ((-x0[1]) % P, x0[0])  # u x0
    else:
        cand = fp2_mul(fp2_pow(fp2_add(FP2_ONE, alpha), (P - 1) // 2), x0)
    return cand if fp2_square(cand) == a else None


# --- Fp6 = Fp2[v]/(v^3 - (u + 1)), Fp12 = Fp6[w]/(w^2 - v) ----------------

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)
FP12_ZERO = (FP6_ZERO, FP6_ZERO)
FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp6_add(a, b):
    return tuple(fp2_add(x, y) for x, y in zip(a, b))


def fp6_sub(a, b):
    return tuple(fp2_sub(x, y) for x, y in zip(a, b))


def fp6_neg(a):
    return tuple(fp2_neg(x) for x in a)


def fp6_mul(a, b):
    """c0 = a0 b0 + xi (a1 b2 + a2 b1), c1 = a0 b1 + a1 b0 + xi a2 b2,
    c2 = a0 b2 + a1 b1 + a2 b0 (fp6.rs:195-274)."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    c0 = fp2_add(fp2_mul(a0, b0), fp2_mul_by_nonresidue(
        fp2_add(fp2_mul(a1, b2), fp2_mul(a2, b1))))
    c1 = fp2_add(fp2_add(fp2_mul(a0, b1), fp2_mul(a1, b0)),
                 fp2_mul_by_nonresidue(fp2_mul(a2, b2)))
    c2 = fp2_add(fp2_add(fp2_mul(a0, b2), fp2_mul(a2, b0)), fp2_mul(a1, b1))
    return (c0, c1, c2)


def fp6_square(a):
    return fp6_mul(a, a)


def fp6_mul_by_nonresidue(a):
    """Multiply by v: (xi c2, c0, c1) (fp6.rs:139-150)."""
    return (fp2_mul_by_nonresidue(a[2]), a[0], a[1])


def fp6_inv(a):
    """Adjugate inversion with one Fp2 inversion (fp6.rs:294-312)."""
    a0, a1, a2 = a
    c0 = fp2_sub(fp2_square(a0), fp2_mul_by_nonresidue(fp2_mul(a1, a2)))
    c1 = fp2_sub(fp2_mul_by_nonresidue(fp2_square(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_square(a1), fp2_mul(a0, a2))
    t = fp2_add(fp2_mul_by_nonresidue(fp2_add(fp2_mul(a1, c2),
                                              fp2_mul(a2, c1))),
                fp2_mul(a0, c0))
    tinv = fp2_inv(t)
    return (fp2_mul(c0, tinv), fp2_mul(c1, tinv), fp2_mul(c2, tinv))


def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_mul(a, b):
    """Karatsuba over Fp6 (fp12.rs:197-213)."""
    a0, a1 = a
    b0, b1 = b
    t0, t1 = fp6_mul(a0, b0), fp6_mul(a1, b1)
    c1 = fp6_sub(fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1)), t0), t1)
    return (fp6_add(t0, fp6_mul_by_nonresidue(t1)), c1)


def fp12_square(a):
    return fp12_mul(a, a)


def fp12_conjugate(a):
    """a^(p^6) (fp12.rs:130-141)."""
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    """1/(c0 + c1 w) via the norm c0^2 - v c1^2 (fp12.rs:187-194)."""
    a0, a1 = a
    t = fp6_sub(fp6_mul(a0, a0), fp6_mul_by_nonresidue(fp6_mul(a1, a1)))
    tinv = fp6_inv(t)
    return (fp6_mul(a0, tinv), fp6_neg(fp6_mul(a1, tinv)))


def fp12_pow(a, e):
    """a^e (a negative e inverts first), square-and-multiply LSB first."""
    if e < 0:
        return fp12_pow(fp12_inv(a), -e)
    result, base = FP12_ONE, a
    while e > 0:
        if e & 1:
            result = fp12_mul(result, base)
        base = fp12_square(base)
        e >>= 1
    return result


# --- Frobenius coefficients (computed, not transcribed) -------------------

XI = (1, 1)  # u + 1, the Fp6 nonresidue

# gamma_6[i] = xi^(i (p - 1) / 3) for the Fp6 Frobenius; gamma_12 = xi^((p - 1) / 6)
FROB6_C1 = fp2_pow(XI, (P - 1) // 3)
FROB6_C2 = fp2_pow(XI, 2 * (P - 1) // 3)
FROB12_C1 = fp2_pow(XI, (P - 1) // 6)


def fp6_frobenius(a):
    return (fp2_conjugate(a[0]), fp2_mul(fp2_conjugate(a[1]), FROB6_C1),
            fp2_mul(fp2_conjugate(a[2]), FROB6_C2))


def fp12_frobenius(a):
    """a^p (fp12.rs:145-171)."""
    return (fp6_frobenius(a[0]),
            tuple(fp2_mul(x, FROB12_C1) for x in fp6_frobenius(a[1])))


# --- the scalar field Fq ("Fr" in device code) -----------------------------


def fr_inv(a):
    if a % Q == 0:
        raise ZeroDivisionError("inversion of zero in Fq")
    return pow(a, Q - 2, Q)


def fr_sqrt(a):
    """Tonelli-Shanks square root in Fq (q - 1 = 2^32 t, the non-square 7);
    None for a non-square."""
    a %= Q
    if a == 0:
        return 0
    if pow(a, (Q - 1) // 2, Q) != 1:
        return None
    m, t = 32, (Q - 1) >> 32
    c, u, r = pow(7, t, Q), pow(a, t, Q), pow(a, (t + 1) // 2, Q)
    while u != 1:
        i, v = 0, u  # the least i with u^(2^i) = 1
        while v != 1:
            v, i = v * v % Q, i + 1
        b = pow(c, 1 << (m - i - 1), Q)
        m, c = i, b * b % Q
        u, r = u * c % Q, r * b % Q
    return r


def fr_from_bytes_wide(data: bytes) -> int:
    """64 little-endian bytes reduced mod q (scalar.rs:300-331)."""
    if len(data) != 64:
        raise ValueError("fr_from_bytes_wide takes 64 bytes")
    return int.from_bytes(data, "little") % Q


def fr_to_bytes(a):
    return (a % Q).to_bytes(32, "little")


def fr_from_bytes(data):
    v = int.from_bytes(data, "little")
    return v if v < Q else None


# --- affine group law (vartime; example inputs and checks only) -----------


class _Curve:
    """y^2 = x^3 + b over a field given by its operations; None is the
    point at infinity."""

    def __init__(self, add, sub, mul, inv, b, zero):
        self.add, self.sub, self.mul, self.inv = add, sub, mul, inv
        self.b, self.zero = b, zero

    def negate(self, pt):
        return None if pt is None else (pt[0], self.sub(self.zero, pt[1]))

    def is_on_curve(self, pt):
        if pt is None:
            return True
        x, y = pt
        return self.mul(y, y) == self.add(self.mul(self.mul(x, x), x), self.b)

    def double(self, pt):
        if pt is None or pt[1] == self.zero:
            return None
        x, y = pt
        xx = self.mul(x, x)
        lam = self.mul(self.add(self.add(xx, xx), xx), self.inv(self.add(y, y)))
        x3 = self.sub(self.mul(lam, lam), self.add(x, x))
        return (x3, self.sub(self.mul(lam, self.sub(x, x3)), y))

    def point_add(self, p1, p2):
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
        """[k]pt; a negative k gives [|k|](-pt)."""
        if k < 0:
            return self.scalar_mul(self.negate(pt), -k)
        acc = None
        for bit in bin(k)[2:] if k else "":
            acc = self.double(acc)
            if bit == "1":
                acc = self.point_add(acc, pt)
        return acc


G1_CURVE = _Curve(fp_add, fp_sub, fp_mul, fp_inv, B_G1, 0)
G2_CURVE = _Curve(fp2_add, fp2_sub, fp2_mul, fp2_inv, B_G2, FP2_ZERO)

g1_add, g1_double, g1_neg = (G1_CURVE.point_add, G1_CURVE.double,
                             G1_CURVE.negate)
g1_mul, g1_is_on_curve = G1_CURVE.scalar_mul, G1_CURVE.is_on_curve
g2_add, g2_double, g2_neg = (G2_CURVE.point_add, G2_CURVE.double,
                             G2_CURVE.negate)
g2_mul, g2_is_on_curve = G2_CURVE.scalar_mul, G2_CURVE.is_on_curve


def g1_is_torsion_free(pt):
    return g1_mul(pt, Q) is None


def g2_is_torsion_free(pt):
    return g2_mul(pt, Q) is None


def g1_clear_cofactor(pt):
    return g1_mul(pt, H_EFF_G1)


def g2_clear_cofactor(pt):
    return g2_mul(pt, H_EFF_G2)


def g1_point_outside_subgroup():
    """The curve point (x, y) with the least x >= 5 that is not in G1."""
    x = 5
    while True:
        y = fp_sqrt((x * x * x + B_G1) % P)
        if y is not None and not g1_is_torsion_free((x, y)):
            return (x, y)
        x += 1


def g2_point_outside_subgroup():
    """The point of E'(Fp2) with x = (k, 1), k >= 1 least, that is not in
    G2 (a square root by fp2_sqrt)."""
    k = 1
    while True:
        x = (k, 1)
        y = fp2_sqrt(fp2_add(fp2_mul(fp2_square(x), x), B_G2))
        if y is not None and not g2_is_torsion_free((x, y)):
            return (x, y)
        k += 1


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


def _compute_psi_constants():
    """psi(x, y) = (c_x conj(x), c_y conj(y)) with c_x = 1/xi^((p-1)/3),
    c_y = 1/xi^((p-1)/2) (g2.rs:847-888)."""
    return (fp2_inv(fp2_pow(XI, (P - 1) // 3)),
            fp2_inv(fp2_pow(XI, (P - 1) // 2)))


PSI_CX, PSI_CY = _compute_psi_constants()


def g2_psi(pt):
    if pt is None:
        return None
    x, y = pt
    return (fp2_mul(fp2_conjugate(x), PSI_CX),
            fp2_mul(fp2_conjugate(y), PSI_CY))


# --- the pairing (affine Miller loop; Gt's generator and the oracles) -----
#
# The line through T (and Q) in E'(Fp2), evaluated at P = (xp, yp), is the
# sparse Fp12 element xi yp + (lam xt - yt) v w - lam xp v^2 w ("045"),
# lam the affine slope.


def _sparse_line_045(l0, l4, l5):
    """The Fp12 element l0 + l4 v w + l5 v^2 w."""
    return ((l0, FP2_ZERO, FP2_ZERO), (FP2_ZERO, l4, l5))


def _line_through(t, lam, x3, p):
    """(T', the line of slope lam through T at P), T' = (x3, lam (xt - x3)
    - yt)."""
    (xt, yt), (xp, yp) = t, p
    return ((x3, fp2_sub(fp2_mul(lam, fp2_sub(xt, x3)), yt)),
            _sparse_line_045(fp2_mul_by_nonresidue((yp, 0)),
                             fp2_sub(fp2_mul(lam, xt), yt),
                             fp2_neg(fp2_mul_fp(lam, xp))))


def _line_double(t, p):
    """The tangent at T in E'(Fp2), evaluated at P: (2T, line)."""
    xt, yt = t
    lam = fp2_mul(fp2_mul_fp(fp2_square(xt), 3), fp2_inv(fp2_add(yt, yt)))
    return _line_through(t, lam, fp2_sub(fp2_square(lam), fp2_add(xt, xt)),
                         p)


def _line_add(t, q, p):
    """The chord through T and Q in E'(Fp2), evaluated at P: (T + Q,
    line)."""
    (xt, yt), (xq, yq) = t, q
    lam = fp2_mul(fp2_sub(yq, yt), fp2_inv(fp2_sub(xq, xt)))
    return _line_through(t, lam, fp2_sub(fp2_sub(fp2_square(lam), xt), xq),
                         p)


def miller_loop(p, q):
    """f_{|z|,Q}(P), conjugated for z < 0 (pairings.rs:668-694): the bits
    of BLS_X below the MSB, a doubling step each and an addition step at
    each set bit."""
    if p is None or q is None:
        return FP12_ONE
    f, t = FP12_ONE, q
    for bit in bin(BLS_X)[3:]:
        t, line = _line_double(t, p)
        f = fp12_mul(fp12_square(f), line)
        if bit == "1":
            t, line = _line_add(t, q, p)
            f = fp12_mul(f, line)
    return fp12_conjugate(f) if BLS_X_IS_NEGATIVE else f


def multi_miller_loop(terms):
    """The product of the Miller values of (P, Q) pairs."""
    f = FP12_ONE
    for p, q in terms:
        f = fp12_mul(f, miller_loop(p, q))
    return f


def final_exponentiation(f):
    """The easy part (p^6 - 1)(p^2 + 1), then the hard part by its plain
    exponent 3 (p^4 - p^2 + 1) / q: the reference's output (RELIC's value)
    is the (p^12 - 1) / q power cubed."""
    f = fp12_mul(fp12_conjugate(f), fp12_inv(f))
    f = fp12_mul(fp12_frobenius(fp12_frobenius(f)), f)
    return fp12_pow(f, 3 * (P ** 4 - P ** 2 + 1) // Q)


def pairing(p, q):
    return final_exponentiation(miller_loop(p, q))


@functools.lru_cache(maxsize=None)
def gt_generator():
    """e(G1, G2), the generator of Gt (pairings.rs:359-475)."""
    return pairing(G1_GEN, G2_GEN)


# --- signs and serialization (notes/serialization.rs, g1.rs:221-390) -----


def fp_lexicographically_largest(a):
    """a > (p - 1) / 2 (fp.rs:273)."""
    return a % P > (P - 1) // 2


def fp2_lexicographically_largest(a):
    """c1-major lexicographic order (fp2.rs:171-180)."""
    if a[1] % P != 0:
        return fp_lexicographically_largest(a[1])
    return fp_lexicographically_largest(a[0])


def fp_to_bytes(a):
    return (a % P).to_bytes(48, "big")


def fp_from_bytes(data):
    v = int.from_bytes(data, "big")
    return v if v < P else None


def fp2_to_bytes(a):
    """Fp2 serializes c1 then c0 (g2.rs:254-282)."""
    return fp_to_bytes(a[1]) + fp_to_bytes(a[0])


def _flags(data):
    """(compression, infinity, sort) bits of an encoding's first byte."""
    return data[0] >> 7 & 1, data[0] >> 6 & 1, data[0] >> 5 & 1


def g1_to_compressed(pt):
    if pt is None:
        return bytes([0b1100_0000]) + bytes(47)
    out = bytearray(fp_to_bytes(pt[0]))
    out[0] |= 0b1000_0000
    if fp_lexicographically_largest(pt[1]):
        out[0] |= 0b0010_0000
    return bytes(out)


def g1_to_uncompressed(pt):
    if pt is None:
        return bytes([0b0100_0000]) + bytes(95)
    return fp_to_bytes(pt[0]) + fp_to_bytes(pt[1])


def g1_from_compressed(data, check_subgroup=True):
    """The point, or ValueError for a malformed encoding."""
    compression, infinity, sort = _flags(data)
    if not compression:
        raise ValueError("compression flag not set")
    x = fp_from_bytes(bytes([data[0] & 0b0001_1111]) + data[1:48])
    if x is None:
        raise ValueError("non-canonical x")
    if infinity:
        if sort or x != 0:
            raise ValueError("malformed infinity encoding")
        return None
    y = fp_sqrt((x * x % P * x + B_G1) % P)
    if y is None:
        raise ValueError("x not on curve")
    if fp_lexicographically_largest(y) != bool(sort):
        y = (-y) % P
    if check_subgroup and not g1_is_torsion_free((x, y)):
        raise ValueError("not in subgroup")
    return (x, y)


def g1_from_uncompressed(data, check=True):
    compression, infinity, sort = _flags(data)
    if compression or sort:
        raise ValueError("bad flags")
    x = fp_from_bytes(bytes([data[0] & 0b0001_1111]) + data[1:48])
    y = fp_from_bytes(data[48:96])
    if x is None or y is None:
        raise ValueError("non-canonical coordinate")
    if infinity:
        if x != 0 or y != 0:
            raise ValueError("malformed infinity encoding")
        return None
    if check and not (g1_is_on_curve((x, y)) and g1_is_torsion_free((x, y))):
        raise ValueError("invalid point")
    return (x, y)


def g2_to_compressed(pt):
    if pt is None:
        return bytes([0b1100_0000]) + bytes(95)
    out = bytearray(fp2_to_bytes(pt[0]))
    out[0] |= 0b1000_0000
    if fp2_lexicographically_largest(pt[1]):
        out[0] |= 0b0010_0000
    return bytes(out)


def g2_to_uncompressed(pt):
    if pt is None:
        return bytes([0b0100_0000]) + bytes(191)
    return fp2_to_bytes(pt[0]) + fp2_to_bytes(pt[1])


def g2_from_compressed(data, check_subgroup=True):
    compression, infinity, sort = _flags(data)
    if not compression:
        raise ValueError("compression flag not set")
    xc1 = fp_from_bytes(bytes([data[0] & 0b0001_1111]) + data[1:48])
    xc0 = fp_from_bytes(data[48:96])
    if xc0 is None or xc1 is None:
        raise ValueError("non-canonical x")
    if infinity:
        if sort or xc0 != 0 or xc1 != 0:
            raise ValueError("malformed infinity encoding")
        return None
    x = (xc0, xc1)
    y = fp2_sqrt(fp2_add(fp2_mul(fp2_square(x), x), B_G2))
    if y is None:
        raise ValueError("x not on curve")
    if fp2_lexicographically_largest(y) != bool(sort):
        y = fp2_neg(y)
    if check_subgroup and not g2_is_torsion_free((x, y)):
        raise ValueError("not in subgroup")
    return (x, y)


def g2_from_uncompressed(data, check=True):
    compression, infinity, sort = _flags(data)
    if compression or sort:
        raise ValueError("bad flags")
    xc1 = fp_from_bytes(bytes([data[0] & 0b0001_1111]) + data[1:48])
    xc0 = fp_from_bytes(data[48:96])
    yc1 = fp_from_bytes(data[96:144])
    yc0 = fp_from_bytes(data[144:192])
    if None in (xc0, xc1, yc0, yc1):
        raise ValueError("non-canonical coordinate")
    if infinity:
        if (xc0, xc1, yc0, yc1) != (0, 0, 0, 0):
            raise ValueError("malformed infinity encoding")
        return None
    pt = ((xc0, xc1), (yc0, yc1))
    if check and not (g2_is_on_curve(pt) and g2_is_torsion_free(pt)):
        raise ValueError("invalid point")
    return pt


# --- hash_to_field (draft-irtf-cfrg-hash-to-curve-16 §5; expand_msg.rs) --


def _i2osp(v, length):
    return v.to_bytes(length, "big")


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int,
                       hash_name="sha256"):
    """expand_message_xmd (draft-16 §5.3.1, expand_msg.rs:230-328), a DST
    over 255 bytes first reduced (§5.3.3)."""
    h = hashlib.new(hash_name)
    b_in_bytes, s_in_bytes = h.digest_size, h.block_size
    if len(dst) > 255:
        dst = hashlib.new(hash_name, b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = -(-len_in_bytes // b_in_bytes)
    if ell > 255 or len_in_bytes > 65535:
        raise ValueError("len_in_bytes too large")
    dst_prime = dst + _i2osp(len(dst), 1)
    b0 = hashlib.new(hash_name, bytes(s_in_bytes) + msg
                     + _i2osp(len_in_bytes, 2) + b"\x00"
                     + dst_prime).digest()
    blocks = [hashlib.new(hash_name, b0 + b"\x01" + dst_prime).digest()]
    for i in range(2, ell + 1):
        xored = bytes(a ^ b for a, b in zip(b0, blocks[-1]))
        blocks.append(hashlib.new(hash_name, xored + _i2osp(i, 1)
                                  + dst_prime).digest())
    return b"".join(blocks)[:len_in_bytes]


def expand_message_xof(msg: bytes, dst: bytes, len_in_bytes: int,
                       hash_name="shake_128"):
    """expand_message_xof (draft-16 §5.3.2, expand_msg.rs:167-217), a DST
    over 255 bytes first reduced to 2k/8 bytes (k = 128 or 256)."""
    if len(dst) > 255:
        k = 128 if hash_name == "shake_128" else 256
        dst = hashlib.new(hash_name, b"H2C-OVERSIZE-DST-" + dst).digest(
            2 * k // 8)
    if len_in_bytes > 65535:
        raise ValueError("len_in_bytes too large")
    return hashlib.new(hash_name, msg + _i2osp(len_in_bytes, 2) + dst
                       + _i2osp(len(dst), 1)).digest(len_in_bytes)


def fp_from_okm(okm: bytes):
    """L = 64 bytes, big-endian, as two 32-byte halves db 2^256 + da
    (map_g1.rs:513-531)."""
    if len(okm) != 64:
        raise ValueError("fp_from_okm takes 64 bytes")
    db = int.from_bytes(okm[:32], "big") % P
    da = int.from_bytes(okm[32:], "big") % P
    return (db * (1 << 256) + da) % P


def fp2_from_okm(okm: bytes):
    if len(okm) != 128:
        raise ValueError("fp2_from_okm takes 128 bytes")
    return (fp_from_okm(okm[:64]), fp_from_okm(okm[64:]))


def fr_from_okm(okm: bytes):
    """L = 48 bytes, big-endian, reduced mod q (map_scalar.rs:10-23)."""
    if len(okm) != 48:
        raise ValueError("fr_from_okm takes 48 bytes")
    return int.from_bytes(okm, "big") % Q


def hash_to_field_fp(msg, dst, count, expand=expand_message_xmd, **kw):
    okm = expand(msg, dst, count * 64, **kw)
    return [fp_from_okm(okm[i * 64:(i + 1) * 64]) for i in range(count)]


def hash_to_field_fp2(msg, dst, count, expand=expand_message_xmd, **kw):
    okm = expand(msg, dst, count * 128, **kw)
    return [fp2_from_okm(okm[i * 128:(i + 1) * 128]) for i in range(count)]


def hash_to_field_fr(msg, dst, count, expand=expand_message_xmd, **kw):
    okm = expand(msg, dst, count * 48, **kw)
    return [fr_from_okm(okm[i * 48:(i + 1) * 48]) for i in range(count)]


# --- hash to curve (draft-irtf-cfrg-hash-to-curve-16 §6.6.2, §8.8;
# map_g1.rs, map_g2.rs): the simplified SWU map onto the isogenous curve,
# the 11- / 3-isogeny, cofactor clearing; the constants are
# params.ISO_CONSTS


def _sswu(u, A, B, Z, field):
    """The simplified SWU map onto y^2 = x^3 + A x + B (draft-16 appendix
    F.2's straight-line recipe): affine (x, y) with sgn0(y) = sgn0(u)."""
    add, neg, mul, sqr, inv = (field["add"], field["neg"], field["mul"],
                               field["sqr"], field["inv"])
    sqrt, sgn0, one, zero = (field["sqrt"], field["sgn0"], field["one"],
                             field["zero"])
    z_usq = mul(Z, sqr(u))
    tv = add(sqr(z_usq), z_usq)       # Z^2 u^4 + Z u^2
    x1num = mul(B, add(tv, one))      # B (tv + 1)
    x1den = mul(A, neg(tv)) if tv != zero else mul(Z, A)
    # g(x1) = x1^3 + A x1 + B as a fraction over x1den^3
    gxd = mul(sqr(x1den), x1den)
    gxn = add(add(mul(sqr(x1num), x1num), mul(mul(A, x1num), sqr(x1den))),
              mul(B, gxd))
    g = mul(gxn, inv(gxd))
    y = sqrt(g)
    if y is not None:
        x = mul(x1num, inv(x1den))
    else:
        # x2 = Z u^2 x1, g(x2) = g(x1) Z^3 u^6
        y = sqrt(mul(g, mul(sqr(z_usq), z_usq)))
        if y is None:
            raise AssertionError("neither g(x1) nor g(x2) is a square")
        x = mul(mul(z_usq, x1num), inv(x1den))
    if sgn0(y) != sgn0(u):
        y = neg(y)
    return (x, y)


_FP_FIELD = dict(
    add=fp_add, sub=fp_sub, neg=fp_neg, mul=fp_mul, sqr=lambda a: a * a % P,
    inv=fp_inv, sqrt=fp_sqrt, sgn0=fp_sgn0, one=1, zero=0,
)
_FP2_FIELD = dict(
    add=fp2_add, sub=fp2_sub, neg=fp2_neg, mul=fp2_mul, sqr=fp2_square,
    inv=fp2_inv, sqrt=fp2_sqrt, sgn0=fp2_sgn0, one=FP2_ONE, zero=FP2_ZERO,
)


def _iso_map(pt, xnum, xden, ynum, yden, field):
    """A rational isogeny map at an affine point (Horner; coefficients
    lowest degree first)."""
    mul, add, inv = field["mul"], field["add"], field["inv"]
    x, y = pt

    def horner(coeffs):
        acc = coeffs[-1]
        for c in reversed(coeffs[:-1]):
            acc = add(mul(acc, x), c)
        return acc

    xn, xd, yn, yd = horner(xnum), horner(xden), horner(ynum), horner(yden)
    return (mul(xn, inv(xd)), mul(y, mul(yn, inv(yd))))


def _map_to_curve(u, group, iso, field):
    c = ISO_CONSTS
    return _iso_map(
        _sswu(u, c[f"{group}_sswu_a"], c[f"{group}_sswu_b"],
              c[f"{group}_sswu_xi"], field),
        *(c[f"{iso}_{part}"] for part in ("xnum", "xden", "ynum", "yden")),
        field)


def map_to_curve_g1(u):
    """SSWU and the 11-isogeny (map_g1.rs:545-630)."""
    return _map_to_curve(u, "g1", "iso11", _FP_FIELD)


def map_to_curve_g2(u):
    """SSWU and the 3-isogeny (map_g2.rs:391-492)."""
    return _map_to_curve(u, "g2", "iso3", _FP2_FIELD)


def hash_to_curve_g1(msg, dst, expand=expand_message_xmd, **kw):
    u0, u1 = hash_to_field_fp(msg, dst, 2, expand=expand, **kw)
    return g1_clear_cofactor(g1_add(map_to_curve_g1(u0), map_to_curve_g1(u1)))


def encode_to_curve_g1(msg, dst, expand=expand_message_xmd, **kw):
    (u,) = hash_to_field_fp(msg, dst, 1, expand=expand, **kw)
    return g1_clear_cofactor(map_to_curve_g1(u))


def hash_to_curve_g2(msg, dst, expand=expand_message_xmd, **kw):
    u0, u1 = hash_to_field_fp2(msg, dst, 2, expand=expand, **kw)
    return g2_clear_cofactor(g2_add(map_to_curve_g2(u0), map_to_curve_g2(u1)))


def encode_to_curve_g2(msg, dst, expand=expand_message_xmd, **kw):
    (u,) = hash_to_field_fp2(msg, dst, 1, expand=expand, **kw)
    return g2_clear_cofactor(map_to_curve_g2(u))
