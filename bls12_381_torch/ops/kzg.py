"""PeerDAS cell-proof batch verification (EIP-7594): consensus-specs
`fulu/polynomial-commitments-sampling.md` `verify_cell_kzg_proof_batch`,
bytes in, one verdict out.  The port's second module without a JAX
counterpart, after `ops/aggregate.py`.

A cell k of a blob is FIELD_ELEMENTS_PER_CELL = 64 evaluations of the
blob's polynomial p (degree < 4096) on the coset
bit_reversal_permutation(roots of unity of order 8192)[64 c : 64 c + 64]
of its index c < 128, with a KZG proof pi_k of that opening against the
blob's commitment C.  One call checks every cell of a batch at once with
the spec's random linear combination: r from one SHA-256 over the batch
(`compute_verify_cell_kzg_proof_batch_challenge`), then

  e(LL, [tau^64]G2) = e(RL, G2),   LL = sum_k r^k pi_k,
  RL = sum_i w_i C_i - [sum_k r^k I_k(tau)]G1 + sum_k r^k h_k^64 pi_k,

w_i the sum of r^k over the cells of commitment i, I_k the interpolant
of cell k's evaluations, h_k its coset's shift.  The stages, each a span
of `utils/profiling.py` inside `kzg`:

  kzg.decode     the spec's length and index checks, the commitments
                 deduplicated in order of first appearance (on the host),
                 commitments and proofs parsed with the subgroup check in
                 one call of `curves/g1.py` `from_compressed_host` (the
                 compressed identity is valid: `validate_kzg_g1`), the
                 field elements by `fields/fr.py` `from_bytes_be` on the
                 device (values >= q refused)
  kzg.challenge  the transcript and its SHA-256, on a thread of the host
                 from the start of the decode on (a span timed there)
  kzg.interp     r's powers; per cell a 64-point inverse NTT of the cell
                 permuted by brp6 (`ops/ntt.py`; element j of the coset
                 is h_c w64^brp6(j), so I_c(h_c X) has the inverse NTT of
                 that order as its coefficients), the shift h_c^-j, the
                 weight r^k; the sum to 64 coefficients; w_i; r^k h_k^64
  kzg.msm        LL and RL as two `msm_g1` over the same points
                 [commitments | setup | proofs] (LL's scalars zero on the
                 first two): one graph shape replayed twice
  kzg.pairing    one two-pair check (`pairing.pairing_check`: e(LL,
                 [tau^64]G2) e(-RL, G2) = 1, the G2 side prepared once in
                 `Setup`)

On the card the decode's curve work, the interpolation, the MSMs and the
pairing each replay a CUDA graph per shape (`utils/graphs.py`): four
shapes a batch size, within `graphs.SLOTS`.  CPU tensors run the same
steps in plain torch.  Any failed assertion of the spec is a False
verdict, not an exception.  `kernels.CELLS` counts calls, cells,
commitments and verdicts.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time

import numpy as np
import torch

from .. import params
from ..curves import g1, g2
from ..fields import fr
from ..kernels import CELLS
from ..pairing.pairing import pairing_check, prepare_g2
from ..utils import graphs, profiling
from . import msm, ntt

FIELD_ELEMENTS_PER_BLOB = 4096
FIELD_ELEMENTS_PER_EXT_BLOB = 8192
FIELD_ELEMENTS_PER_CELL = 64
CELLS_PER_EXT_BLOB = FIELD_ELEMENTS_PER_EXT_BLOB // FIELD_ELEMENTS_PER_CELL
BYTES_PER_FIELD_ELEMENT = 32
BYTES_PER_CELL = FIELD_ELEMENTS_PER_CELL * BYTES_PER_FIELD_ELEMENT
BYTES_PER_COMMITMENT = BYTES_PER_PROOF = 48
DOMAIN = b"RCKZGCBATCH__V1_"  # RANDOM_CHALLENGE_KZG_CELL_BATCH_DOMAIN
# a cell's transcript row: commitment index, cell index, cell, proof
ROW_BYTES = 8 + 8 + BYTES_PER_CELL + BYTES_PER_PROOF
HASH_ROWS = 4096  # rows built and hashed at a time (8.6 MB)
MSM_WINDOW = msm.MSM_WINDOW


def bit_reversal_permutation(n: int) -> np.ndarray:
    """The index array of the spec's `bit_reversal_permutation` over n = 2^b
    elements: position i holds element brp_b(i)."""
    bits = n.bit_length() - 1
    i = np.arange(n)
    rev = np.zeros_like(i)
    for b in range(bits):
        rev |= ((i >> b) & 1) << (bits - 1 - b)
    return rev


def coset_shifts() -> list[int]:
    """h_c for c < 128: the first element of cell c's coset, the
    (brp13(64 c))-th power of the 8192-th root of unity (the spec's
    `coset_shift_for_cell`), as canonical ints."""
    root = fr.root_of_unity_pow(1 << (fr.S - 13))
    brp = bit_reversal_permutation(FIELD_ELEMENTS_PER_EXT_BLOB)
    return [pow(root, int(brp[FIELD_ELEMENTS_PER_CELL * c]), params.Q)
            for c in range(CELLS_PER_EXT_BLOB)]


class Setup:
    """The verifier's share of a KZG setup, on one device: the 64 G1
    monomial points [tau^i]G1 (KZG_SETUP_G1_MONOMIAL[:64], an affine
    batch [64]), [tau^64]G2 (KZG_SETUP_G2_MONOMIAL[64], an affine G2
    batch [1] or ()) and G2's generator, prepared once for the pairing;
    and the coset tables: h_c^-j [16, 128, 64], h_c^64 [16, 128] and the
    index brp6 [64]."""

    def __init__(self, g1_monomial, g2_tau_n):
        x = g1_monomial[0]
        if x.shape[1:] != (FIELD_ELEMENTS_PER_CELL,):
            raise ValueError(f"expected {FIELD_ELEMENTS_PER_CELL} G1 monomial "
                             f"points, got a batch {tuple(x.shape[1:])}")
        dev = self.device = x.device
        self.g1_monomial, self.g2_tau_n = g1_monomial, g2_tau_n
        (qx0, qx1), (qy0, qy1), qinf = g2_tau_n
        flat = lambda t: t.reshape(t.shape[:1] + (1,))  # noqa: E731
        gen = g2.generator_affine((1,), dev)
        cat = lambda a, b: torch.cat([a, b], -1)  # noqa: E731
        q = ((cat(flat(qx0), gen[0][0]), cat(flat(qx1), gen[0][1])),
             (cat(flat(qy0), gen[1][0]), cat(flat(qy1), gen[1][1])),
             cat(qinf.reshape(1), gen[2]))
        self.g2_prepared = prepare_g2(q)
        q_ = params.Q
        h = coset_shifts()
        n = FIELD_ELEMENTS_PER_CELL
        hinv = [pow(v, q_ - 2, q_) for v in h]
        self.shift_inv = fr.from_ints(np.array(
            [[pow(v, j, q_) for j in range(n)] for v in hinv], dtype=object),
            device=dev)
        self.shift_pow_n = fr.from_ints(np.array(
            [pow(v, n, q_) for v in h], dtype=object), device=dev)
        self.brp6 = torch.as_tensor(bit_reversal_permutation(n), device=dev)


@dataclasses.dataclass
class Decoded:
    """A batch that passed every check of the spec's decoding: the
    deduplicated commitments' bytes [n_c, 48] (host); the commitments' then
    the proofs' affine points [n_c + K], each cell's column and commitment
    index (int64 [K]) and its field elements as Montgomery Fr [16, K, 64]
    (device)."""
    commitments: np.ndarray
    points: tuple
    columns: torch.Tensor
    owner: torch.Tensor
    evals: torch.Tensor


def _rows(a, width: int) -> np.ndarray | None:
    a = np.asarray(a)
    if a.dtype != np.uint8 or a.ndim != 2 or a.shape[1] != width:
        return None
    return a


def _parse(commitments, cell_indices, cells, proofs):
    """The spec's assertions on lengths and indices, on the host, and the
    deduplication: (unique commitments, owner int64 [K], cell indices
    int64 [K], cells, proofs), or None where an assertion fails."""
    commitments = _rows(commitments, BYTES_PER_COMMITMENT)
    proofs = _rows(proofs, BYTES_PER_PROOF)
    cells = _rows(cells, BYTES_PER_CELL)
    idx = np.asarray(cell_indices)
    if commitments is None or proofs is None or cells is None \
            or idx.ndim != 1 or (idx.size and idx.dtype.kind not in "iu"):
        return None
    k = idx.shape[0]
    if not commitments.shape[0] == cells.shape[0] == proofs.shape[0] == k:
        return None
    if k and (idx.min() < 0 or idx.max() >= CELLS_PER_EXT_BLOB):
        return None
    rows = np.ascontiguousarray(commitments).view(
        np.dtype((np.void, BYTES_PER_COMMITMENT)))[:, 0]
    _, first, inverse = np.unique(rows, return_index=True,
                                  return_inverse=True)
    # the deduplicated commitments in order of first appearance
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    return (commitments[first[order]], rank[inverse.reshape(-1)],
            idx.astype(np.int64), cells, proofs)


def _decode_device(parsed, device) -> Decoded | None:
    """The points and field elements of a parsed batch on `device`, or
    None where one fails its check (two reads to the host)."""
    unique, owner, idx, cells, proofs = parsed
    dev = torch.device(device)
    aff, ok = g1.from_compressed_host(np.concatenate([unique, proofs]),
                                      device=dev)
    if not ok.all():
        return None
    data = torch.from_numpy(np.ascontiguousarray(cells)).to(dev)
    evals, fe_ok = fr.from_bytes_be(data.view(
        cells.shape[0], FIELD_ELEMENTS_PER_CELL, BYTES_PER_FIELD_ELEMENT))
    if not bool(fe_ok.all()):
        return None
    return Decoded(unique, aff, torch.from_numpy(idx).to(dev),
                   torch.from_numpy(owner).to(dev), evals)


def decode(commitments, cell_indices, cells, proofs, device="cuda"):
    """The decoding half of `verify_cell_kzg_proof_batch`: a `Decoded`
    batch, or None where the spec's assertions refuse it.  Nothing of
    `_impl` (the challenge, the combinations, the pairing) runs."""
    parsed = _parse(commitments, cell_indices, cells, proofs)
    return None if parsed is None else _decode_device(parsed, device)


def transcript_chunks(commitments, owner, cell_indices, cells, proofs):
    """The bytes of `compute_verify_cell_kzg_proof_batch_challenge`'s hash
    input, in pieces: the domain; FIELD_ELEMENTS_PER_BLOB,
    FIELD_ELEMENTS_PER_CELL, the commitment count and the cell count, 8
    bytes big-endian each; the deduplicated commitments; then per cell its
    commitment index and cell index (8 bytes big-endian each), its 2048
    bytes and its proof, HASH_ROWS cells a piece."""
    k = cell_indices.shape[0]
    yield DOMAIN + b"".join(v.to_bytes(8, "big") for v in (
        FIELD_ELEMENTS_PER_BLOB, FIELD_ELEMENTS_PER_CELL,
        commitments.shape[0], k))
    yield np.ascontiguousarray(commitments).tobytes()
    for lo in range(0, k, HASH_ROWS):
        hi = min(k, lo + HASH_ROWS)
        buf = np.empty((hi - lo, ROW_BYTES), dtype=np.uint8)
        buf[:, 0:8] = owner[lo:hi].astype(">u8").view(np.uint8).reshape(-1, 8)
        buf[:, 8:16] = cell_indices[lo:hi].astype(">u8").view(
            np.uint8).reshape(-1, 8)
        buf[:, 16:16 + BYTES_PER_CELL] = cells[lo:hi]
        buf[:, 16 + BYTES_PER_CELL:] = proofs[lo:hi]
        yield buf


def _digest(pieces, stop=None) -> int | None:
    """int(SHA-256 of the pieces, big-endian) mod q (`hash_to_bls_field`);
    None where `stop` is set between pieces."""
    h = hashlib.sha256()
    for piece in pieces:
        if stop is not None and stop.is_set():
            return None
        h.update(piece)
    return int.from_bytes(h.digest(), "big") % params.Q


def challenge(commitments, owner, cell_indices, cells, proofs) -> int:
    """r of `compute_verify_cell_kzg_proof_batch_challenge`."""
    return _digest(transcript_chunks(commitments, owner, cell_indices, cells,
                                     proofs))


class _Challenge(threading.Thread):
    """`challenge` on a thread of the host, which the decode overlaps
    (hashlib and numpy's copies let go of the GIL); `cancel` stops it
    between pieces."""

    def __init__(self, parsed):
        super().__init__(daemon=True)
        self.parsed, self.stop = parsed, threading.Event()
        self.r = self.error = None
        self.start_ns = self.end_ns = 0
        self.start()

    def run(self):
        try:
            self.start_ns = time.time_ns()
            self.r = _digest(transcript_chunks(*self.parsed), self.stop)
            self.end_ns = time.time_ns()
        except Exception as exc:  # raised to the caller by result()
            self.error = exc

    def result(self) -> int:
        self.join()
        if self.error is not None:
            raise self.error
        return self.r

    def cancel(self) -> None:
        self.stop.set()
        self.join()


def _powers(r: torch.Tensor, n: int) -> torch.Tensor:
    """r^k for k < n as [16, n], from r [16, 1] by doubling: the table so
    far times r^width, then r^width squared."""
    out = fr.one((1,), device=r.device)
    step = r
    while out.shape[-1] < n:
        out = torch.cat([out, fr.mul(out, step)], dim=-1)
        step = fr.sqr(step)
    return out[:, :n]


def interpolants(evals, columns, shift_inv, brp6):
    """Each cell's interpolant I_c, coefficients lowest first [16, K, 64],
    from its evaluations [16, K, 64] (Montgomery) and columns (int64 [K]):
    the inverse NTT of the cell in brp6 order gives I_c(h_c X), and
    coefficient j of I_c is its j-th times h_c^-j (`Setup.shift_inv`)."""
    return fr.mul(ntt.intt(evals[..., brp6]), shift_inv[:, columns])


def _interp(evals, columns, owner, r, shift_inv, shift_pow_n, brp6,
            n_c: int):
    """The scalars of LL and RL over the points [commitments | setup |
    proofs]: (0 | 0 | r^k) and (w_i | -sum_k r^k I_k | r^k h_k^64), each
    [16, n_c + 64 + K].  Nothing is read back to the host; on the card a
    graph per shape replays it (span `kzg.interp.replay`)."""
    k = evals.shape[1]
    coeffs = interpolants(evals, columns, shift_inv, brp6)
    pw = _powers(r, k)
    interp = fr.sum_along(fr.mul(coeffs, pw.unsqueeze(-1)), 1)
    head = fr.zero((n_c + FIELD_ELEMENTS_PER_CELL,), device=evals.device)
    s_ll = torch.cat([head, pw], dim=-1)
    s_rl = torch.cat([fr.segment_sum(pw, owner, n_c), fr.neg(interp),
                      fr.mul(pw, shift_pow_n[:, columns])], dim=-1)
    return s_ll, s_rl


def msm_window(n: int) -> int:
    """The MSM's window at n points: MSM_WINDOW from 2^15 points on, fewer
    bits below, 8 at least (the windows' launches lead at small n)."""
    return max(8, min(MSM_WINDOW, n.bit_length() - 3))


def _lincombs(dec: Decoded, r: int, setup: Setup):
    """LL and RL of a decoded batch and its challenge r, as projective
    points (the spans `kzg.interp`, `kzg.msm`)."""
    dev, n_c = setup.device, dec.commitments.shape[0]
    with profiling.span("kzg.interp"):
        s_ll, s_rl = graphs.graphed(
            "kzg.interp.replay", _interp,
            (dec.evals, dec.columns, dec.owner,
             fr.from_ints([r], device=dev), setup.shift_inv,
             setup.shift_pow_n, setup.brp6), n_c)
    with profiling.span("kzg.msm"):
        cx, cy, cinf = dec.points
        sx, sy, sinf = setup.g1_monomial
        pts = g1.from_affine(tuple(
            torch.cat([a[..., :n_c], b, a[..., n_c:]], dim=-1)
            for a, b in ((cx, sx), (cy, sy), (cinf, sinf))))
        c = msm_window(pts[0].shape[-1])
        return msm.msm_g1(pts, s_ll, c=c), msm.msm_g1(pts, s_rl, c=c)


def _refuse(count: str) -> bool:
    setattr(CELLS, count, getattr(CELLS, count) + 1)
    return False


@profiling.spanned("kzg")
@graphs.releasing
def verify_cell_kzg_proof_batch(commitments, cell_indices, cells, proofs,
                                setup: Setup) -> bool:
    """The spec's `verify_cell_kzg_proof_batch` on `setup`'s device:
    commitments uint8 [K, 48], cell indices int [K], cells uint8 [K, 2048]
    and proofs uint8 [K, 48] (numpy, host) -> one host bool.  False where
    an assertion of the spec fails (lengths, an index >= 128, a point
    that is not the compressed identity and does not decode to G1, a field
    element >= q) and where the pairing check fails."""
    CELLS.calls += 1
    hasher = None
    try:
        with profiling.span("kzg.decode"):
            parsed = _parse(commitments, cell_indices, cells, proofs)
            if parsed is None:
                return _refuse("refused_decode")
            k, n_c = parsed[2].shape[0], parsed[0].shape[0]
            CELLS.cells += k
            CELLS.commitments += n_c
            if k == 0:  # LL and RL are the identity: the check holds
                CELLS.accepted += 1
                return True
            hasher = _Challenge(parsed)
            dec = _decode_device(parsed, setup.device)
            if dec is None:
                return _refuse("refused_decode")
        r = hasher.result()
        profiling.host_span("kzg.challenge", hasher.start_ns, hasher.end_ns)
    finally:
        if hasher is not None:
            hasher.cancel()
    ll, rl = _lincombs(dec, r, setup)
    with profiling.span("kzg.pairing"):
        both = g1.to_affine(tuple(torch.stack([a, b], dim=-1) for a, b in
                                  zip(ll, g1.neg(rl))))
        holds = bool(pairing_check(both, setup.g2_prepared))
    if not holds:
        return _refuse("refused_pairing")
    CELLS.accepted += 1
    return True
