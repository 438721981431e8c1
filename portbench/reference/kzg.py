"""PeerDAS cell-proof batch verification on Python integers.

ethereum/consensus-specs `specs/fulu/polynomial-commitments-sampling.md`,
written from the spec text: `verify_cell_kzg_proof_batch` (lengths,
indices below CELLS_PER_EXT_BLOB, `validate_kzg_g1` of every commitment
and proof, `bytes_to_bls_field` of every field element, the commitments
deduplicated in order of first appearance), then `_impl`: the challenge
of `compute_verify_cell_kzg_proof_batch_challenge`, r's powers, LL, the
weights of RLC, RLI from each cell's interpolant (the spec's
`interpolate_polynomialcoeff` by Lagrange's formula, O(n^2) a cell), RLP,
and the check as one product of two Miller loops and one final
exponentiation.  A failed assertion of the spec is the verdict False.

`g1_lincomb` is a sum of scalar multiplications: each by double-and-add
in Jacobian coordinates (dbl-2009-l, madd-2007-bl: no inversion a step),
then the affine sum.  The setup is given as points: the 64 G1 monomial
points [tau^i]G1 and [tau^64]G2.
"""

from __future__ import annotations

import hashlib

from . import hostmath as hm
from .params import G2_GEN, P, Q

FIELD_ELEMENTS_PER_BLOB = 4096
FIELD_ELEMENTS_PER_EXT_BLOB = 8192
FIELD_ELEMENTS_PER_CELL = 64
CELLS_PER_EXT_BLOB = FIELD_ELEMENTS_PER_EXT_BLOB // FIELD_ELEMENTS_PER_CELL
BYTES_PER_FIELD_ELEMENT = 32
BYTES_PER_CELL = FIELD_ELEMENTS_PER_CELL * BYTES_PER_FIELD_ELEMENT
BYTES_PER_COMMITMENT = BYTES_PER_PROOF = 48
PRIMITIVE_ROOT_OF_UNITY = 7
RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN = b"RCKZGCBATCH__V1_"
G1_POINT_AT_INFINITY = b"\xc0" + bytes(47)
KZG_ENDIANNESS = "big"


# --- field and domain -------------------------------------------------------

def reverse_bits(n: int, order: int) -> int:
    return int(("{:0" + str(order.bit_length() - 1) + "b}").format(n)[::-1],
               2)


def bit_reversal_permutation(sequence) -> list:
    return [sequence[reverse_bits(i, len(sequence))]
            for i in range(len(sequence))]


def compute_powers(x: int, n: int) -> list:
    out, current = [], 1
    for _ in range(n):
        out.append(current)
        current = current * x % Q
    return out


def compute_roots_of_unity(order: int) -> list:
    assert (Q - 1) % order == 0
    return compute_powers(pow(PRIMITIVE_ROOT_OF_UNITY, (Q - 1) // order, Q),
                          order)


_ROOTS_BRP: list = []


def _roots_brp() -> list:
    if not _ROOTS_BRP:
        _ROOTS_BRP.extend(bit_reversal_permutation(
            compute_roots_of_unity(FIELD_ELEMENTS_PER_EXT_BLOB)))
    return _ROOTS_BRP


def coset_for_cell(cell_index: int) -> list:
    assert cell_index < CELLS_PER_EXT_BLOB
    n = FIELD_ELEMENTS_PER_CELL
    return _roots_brp()[n * cell_index:n * (cell_index + 1)]


def coset_shift_for_cell(cell_index: int) -> int:
    assert cell_index < CELLS_PER_EXT_BLOB
    return _roots_brp()[FIELD_ELEMENTS_PER_CELL * cell_index]


def bytes_to_bls_field(b: bytes) -> int:
    field_element = int.from_bytes(b, KZG_ENDIANNESS)
    assert field_element < Q
    return field_element


def cell_to_coset_evals(cell: bytes) -> list:
    w = BYTES_PER_FIELD_ELEMENT
    return [bytes_to_bls_field(cell[i * w:(i + 1) * w])
            for i in range(FIELD_ELEMENTS_PER_CELL)]


def interpolate_polynomialcoeff(xs, ys) -> list:
    """The coefficients (lowest first) of the polynomial of degree < n
    through (xs[i], ys[i]): sum_i ys[i] Z(X) / ((X - xs[i]) Z'(xs[i])),
    Z = prod (X - xs[j]); the quotient by synthetic division and its value
    at xs[i] (= Z'(xs[i])) by Horner's rule."""
    n = len(xs)
    assert len(ys) == n
    z = [1]  # Z's coefficients, lowest first
    for x in xs:
        z = [(a - x * b) % Q for a, b in zip([0] + z, z + [0])]
    out = [0] * n
    for x, y in zip(xs, ys):
        quot = [0] * n  # Z / (X - x)
        carry = 0
        for d in range(n, 0, -1):
            carry = (z[d] + carry * x) % Q
            quot[d - 1] = carry
        denom = 0
        for c in reversed(quot):
            denom = (denom * x + c) % Q
        scale = y * pow(denom, Q - 2, Q) % Q
        for d in range(n):
            out[d] = (out[d] + scale * quot[d]) % Q
    return out


# --- G1 ---------------------------------------------------------------------

def _jac_double(pt):
    x, y, z = pt
    if z == 0 or y == 0:
        return (1, 1, 0)
    a, b = x * x % P, y * y % P
    c = b * b % P
    d = 2 * ((x + b) * (x + b) - a - c) % P
    e = 3 * a % P
    x3 = (e * e - 2 * d) % P
    return (x3, (e * (d - x3) - 8 * c) % P, 2 * y * z % P)


def _jac_add_affine(pt, q):
    x1, y1, z1 = pt
    if z1 == 0:
        return (q[0], q[1], 1)
    zz = z1 * z1 % P
    u2 = q[0] * zz % P
    s2 = q[1] * z1 * zz % P
    h = (u2 - x1) % P
    r = 2 * (s2 - y1) % P
    if h == 0:
        return _jac_double(pt) if r == 0 else (1, 1, 0)
    hh = h * h % P
    i = 4 * hh % P
    j = h * i % P
    v = x1 * i % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * y1 * j) % P
    return (x3, y3, ((z1 + h) * (z1 + h) - zz - hh) % P)


def g1_mul(pt, k: int):
    """[k]pt for an affine point (None the identity) and k >= 0, by
    double-and-add in Jacobian coordinates; affine out."""
    if pt is None or k == 0:
        return None
    acc = (1, 1, 0)
    for bit in bin(k)[2:]:
        acc = _jac_double(acc)
        if bit == "1":
            acc = _jac_add_affine(acc, pt)
    x, y, z = acc
    if z == 0:
        return None
    zi = pow(z, P - 2, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def g1_lincomb(points, scalars):
    total = None
    for pt, k in zip(points, scalars):
        total = hm.g1_add(total, g1_mul(pt, k % Q))
    return total


def validate_kzg_g1(b: bytes):
    """The point of a commitment or proof: the compressed identity, or a
    KeyValidate'd point (decodes, not the identity, in G1); AssertionError
    otherwise."""
    if b == G1_POINT_AT_INFINITY:
        return None
    try:
        pt = hm.g1_from_compressed(b, check_subgroup=False)
    except ValueError as exc:
        raise AssertionError(str(exc)) from exc
    assert pt is not None and g1_mul(pt, Q) is None
    return pt


# --- the spec's functions ---------------------------------------------------

def challenge_transcript(commitments, commitment_indices, cell_indices,
                         cosets_evals, proofs) -> bytes:
    """The hash input of `compute_verify_cell_kzg_proof_batch_challenge`
    (commitments and proofs as their bytes, evaluations as ints)."""
    out = RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN
    out += int.to_bytes(FIELD_ELEMENTS_PER_BLOB, 8, KZG_ENDIANNESS)
    out += int.to_bytes(FIELD_ELEMENTS_PER_CELL, 8, KZG_ENDIANNESS)
    out += int.to_bytes(len(commitments), 8, KZG_ENDIANNESS)
    out += int.to_bytes(len(cell_indices), 8, KZG_ENDIANNESS)
    for commitment in commitments:
        out += commitment
    for k, coset_evals in enumerate(cosets_evals):
        out += int.to_bytes(commitment_indices[k], 8, KZG_ENDIANNESS)
        out += int.to_bytes(cell_indices[k], 8, KZG_ENDIANNESS)
        for coset_eval in coset_evals:
            out += int.to_bytes(coset_eval, BYTES_PER_FIELD_ELEMENT,
                                KZG_ENDIANNESS)
        out += proofs[k]
    return out


def compute_challenge(*args) -> int:
    digest = hashlib.sha256(challenge_transcript(*args)).digest()
    return int.from_bytes(digest, KZG_ENDIANNESS) % Q


def lincombs(setup, commitments, commitment_indices, cell_indices,
             cosets_evals, proof_bytes):
    """(LL, RL) of `_impl` as affine points (None the identity);
    commitments and proofs as their 48 bytes, each already validated."""
    g1_monomial, _ = setup
    n = FIELD_ELEMENTS_PER_CELL
    num_cells = len(cell_indices)
    r = compute_challenge(commitments, commitment_indices, cell_indices,
                          cosets_evals, proof_bytes)
    r_powers = compute_powers(r, num_cells)
    proofs = [validate_kzg_g1(b) for b in proof_bytes]
    ll = g1_lincomb(proofs, r_powers)
    weights = [0] * len(commitments)
    for k in range(num_cells):
        i = commitment_indices[k]
        weights[i] = (weights[i] + r_powers[k]) % Q
    rlc = g1_lincomb([validate_kzg_g1(b) for b in commitments], weights)
    interp = [0] * n
    for k in range(num_cells):
        coeff = interpolate_polynomialcoeff(coset_for_cell(cell_indices[k]),
                                            cosets_evals[k])
        interp = [(a + r_powers[k] * b) % Q for a, b in zip(interp, coeff)]
    rli = g1_lincomb(g1_monomial, interp)
    rlp = g1_lincomb(proofs, [
        r_powers[k] * pow(coset_shift_for_cell(cell_indices[k]), n, Q) % Q
        for k in range(num_cells)])
    rl = hm.g1_add(hm.g1_add(rlc, hm.g1_neg(rli)), rlp)
    return ll, rl


def verify_cell_kzg_proof_batch(commitments_bytes, cell_indices, cells,
                                proofs_bytes, setup) -> bool:
    """The spec's public function over sequences of bytes and ints; setup
    = (the 64 G1 monomial points, [tau^64]G2) as affine points."""
    try:
        assert len(commitments_bytes) == len(cells) == len(proofs_bytes) \
            == len(cell_indices)
        for b in commitments_bytes:
            assert len(b) == BYTES_PER_COMMITMENT
        for cell_index in cell_indices:
            assert 0 <= cell_index < CELLS_PER_EXT_BLOB
        for cell in cells:
            assert len(cell) == BYTES_PER_CELL
        for b in proofs_bytes:
            assert len(b) == BYTES_PER_PROOF
        commitments = [b for i, b in enumerate(commitments_bytes)
                       if commitments_bytes.index(b) == i]
        for b in commitments:
            validate_kzg_g1(b)
        commitment_indices = [commitments.index(b)
                              for b in commitments_bytes]
        cosets_evals = [cell_to_coset_evals(cell) for cell in cells]
        for b in proofs_bytes:
            validate_kzg_g1(b)
    except AssertionError:
        return False
    ll, rl = lincombs(setup, commitments, commitment_indices,
                      list(cell_indices), cosets_evals, list(proofs_bytes))
    f = hm.multi_miller_loop([(ll, setup[1]), (hm.g1_neg(rl), G2_GEN)])
    return hm.final_exponentiation(f) == hm.FP12_ONE
