"""PeerDAS cell-proof batch verification (`ops/kzg.py`) on the CPU against
the plain reference (`portbench/reference/kzg.py`, written from the spec
text on Python integers): the big-endian field decoder's edge rows, the
sums reduced once, the cosets and their shifts, each cell's interpolant
coefficient for coefficient against Lagrange's, the challenge's bytes,
the deduplication, the spec's assertions as False verdicts, and the
verdict on a seeded setup for the honest batch and each fault, equal to
the reference's (the faults that reach the pairing but one are in
`test_torch_kzg_faults.py`, which shares this file's case).

The case: tau from a seed, two blobs of 4096 random coefficients, four
cells each at different columns, made on the host with the reference's
integers (each cell's 64 evaluations by Horner's rule, the proof's
scalar from p mod (X^64 - h_c^64)).  Tolerance: none (integer
arithmetic).
"""

import random
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from bls12_381_torch import params
from bls12_381_torch.fields import fp, fr
from bls12_381_torch.kernels import CELLS
from bls12_381_torch.ops import kzg
from bls12_381_torch.utils import profiling

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "portbench"))
from reference import hostmath as rhm  # noqa: E402
from reference import kzg as ref  # noqa: E402

torch.set_num_threads(1)
Q = params.Q
N = kzg.FIELD_ELEMENTS_PER_CELL
COLUMNS = ((3, 77, 0, 127), (5, 77, 64, 100))
KINDS = ("honest", "wrong_eval", "swapped_proofs", "wrong_column",
         "wrong_commitment", "noncanonical", "proof_outside_g1")
SEED = 2147480424


def horner(p, x):
    acc = 0
    for c in reversed(p):
        acc = (acc * x + c) % Q
    return acc


def make_case(seed=SEED, columns=COLUMNS):
    """(tau, reference setup points, batch): the batch as lists of bytes
    and ints, cells in blob order."""
    rng = random.Random(seed)
    tau = rng.randrange(1, Q)
    setup = ([ref.g1_mul(params.G1_GEN, pow(tau, i, Q)) for i in range(N)],
             rhm.g2_mul(params.G2_GEN, pow(tau, N, Q)))
    batch = {"commitments": [], "cell_indices": [], "cells": [],
             "proofs": [], "blob_commitments": []}
    t_n = pow(tau, N, Q)
    for cols in columns:
        p = [rng.randrange(Q) for _ in range(kzg.FIELD_ELEMENTS_PER_BLOB)]
        p_tau = horner(p, tau)
        commitment = rhm.g1_to_compressed(ref.g1_mul(params.G1_GEN, p_tau))
        batch["blob_commitments"].append(commitment)
        for c in cols:
            a = pow(ref.coset_shift_for_cell(c), N, Q)
            rem = [horner(p[j::N], a) for j in range(N)]  # p mod X^64 - a
            q_tau = (p_tau - horner(rem, tau)) * pow((t_n - a) % Q, Q - 2,
                                                     Q) % Q
            batch["commitments"].append(commitment)
            batch["cell_indices"].append(c)
            batch["cells"].append(b"".join(
                horner(p, x).to_bytes(32, "big")
                for x in ref.coset_for_cell(c)))
            batch["proofs"].append(rhm.g1_to_compressed(
                ref.g1_mul(params.G1_GEN, q_tau)))
    return tau, setup, batch


def with_fault(batch, kind: str, seed: int = 7):
    """A copy of the batch with one fault of `kind` (the spec's inputs as
    lists)."""
    rng = random.Random(seed)
    b = {k: list(v) for k, v in batch.items()}
    n = len(b["cells"])
    k = rng.randrange(n)
    j = rng.randrange(N)
    cell = bytearray(b["cells"][k])
    v = int.from_bytes(cell[32 * j:32 * j + 32], "big")
    if kind == "wrong_eval":
        cell[32 * j:32 * j + 32] = ((v + rng.randrange(1, Q)) % Q).to_bytes(
            32, "big")
    elif kind == "noncanonical":
        cell[32 * j:32 * j + 32] = (v + Q).to_bytes(32, "big")
    elif kind == "swapped_proofs":
        k2 = (k + 1 + rng.randrange(n - 1)) % n
        b["proofs"][k], b["proofs"][k2] = b["proofs"][k2], b["proofs"][k]
    elif kind == "wrong_column":
        b["cell_indices"][k] = (b["cell_indices"][k] + 1 + rng.randrange(
            kzg.CELLS_PER_EXT_BLOB - 1)) % kzg.CELLS_PER_EXT_BLOB
    elif kind == "wrong_commitment":
        mine = b["blob_commitments"].index(b["commitments"][k])
        b["commitments"][k] = b["blob_commitments"][1 - mine]
    elif kind == "proof_outside_g1":
        b["proofs"][k] = rhm.g1_to_compressed(rhm.g1_point_outside_subgroup())
    elif kind != "honest":
        raise ValueError(kind)
    b["cells"][k] = bytes(cell)
    return b


def arrays(batch):
    """The public function's arguments: numpy uint8 rows and int indices."""
    rows = lambda bs: np.array([np.frombuffer(x, np.uint8)  # noqa: E731
                                for x in bs])
    return (rows(batch["commitments"]), np.array(batch["cell_indices"],
                                                 dtype=np.uint64),
            rows(batch["cells"]), rows(batch["proofs"]))


def port_setup(setup, device):
    """kzg.Setup on `device` from the reference's affine points."""
    g1m, (x, y) = setup

    def col(vals):
        return fp.from_ints(np.array(vals, dtype=object), device=device)

    no_inf = torch.zeros(len(g1m), dtype=torch.bool, device=device)
    return kzg.Setup(
        (col([p[0] for p in g1m]), col([p[1] for p in g1m]), no_inf),
        ((col([x[0]]), col([x[1]])), (col([y[0]]), col([y[1]])),
         torch.zeros(1, dtype=torch.bool, device=device)))


def reference_verdict(batch, setup) -> bool:
    return ref.verify_cell_kzg_proof_batch(
        batch["commitments"], batch["cell_indices"], batch["cells"],
        batch["proofs"], setup)


@pytest.fixture(scope="module")
def case():
    tau, setup, batch = make_case()
    return {"tau": tau, "setup": setup, "batch": batch,
            "port": port_setup(setup, "cpu")}


def verdict_matches_reference(case, kind: str):
    batch = with_fault(case["batch"], kind)
    want = reference_verdict(batch, case["setup"])
    assert want == (kind == "honest")
    before = CELLS.snapshot()
    got = kzg.verify_cell_kzg_proof_batch(*arrays(batch), case["port"])
    assert got is want
    return CELLS.since(before)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


def test_big_endian_decoder_edge_rows():
    vals = [0, 1, Q - 1, Q, (1 << 256) - 1, 0x1234 << 200]
    data = np.array([np.frombuffer(v.to_bytes(32, "big"), np.uint8)
                     for v in vals])
    mont, ok = fr.from_bytes_be(data, device="cpu")
    assert ok.tolist() == [v < Q for v in vals]
    got = fr.to_ints(mont)
    assert [int(got[i]) for i in (0, 1, 2, 5)] == [0, 1, Q - 1, 0x1234 << 200]
    # a tensor stays on its device; [*batch, 32] of any batch shape
    mont2, ok2 = fr.from_bytes_be(torch.from_numpy(data).reshape(2, 3, 32))
    assert torch.equal(mont2, mont.reshape(16, 2, 3))
    assert ok2.tolist() == ok.reshape(2, 3).tolist()
    with pytest.raises(ValueError, match="32-byte"):
        fr.from_bytes_be(data[:, :31], device="cpu")


@pytest.mark.parametrize("dim", [1, 2])
def test_sums_reduce_once(dim):
    rng = random.Random(dim)
    xs = [[Q - 1 - rng.randrange(8) if j % 3 else rng.randrange(Q)
           for j in range(40)] for _ in range(3)]
    a = fr.from_ints(np.array(xs, dtype=object), device="cpu")
    got = [int(v) for v in fr.to_ints(fr.sum_along(a, dim))]
    want = [sum(r) % Q for r in xs] if dim == 2 else \
        [sum(r[j] for r in xs) % Q for j in range(40)]
    assert got == want
    with pytest.raises(ValueError, match="limb axis"):
        fr.sum_along(a, 0)


def test_segment_sum_by_index():
    rng = random.Random(3)
    xs = [Q - 1 if k % 4 == 0 else rng.randrange(Q) for k in range(50)]
    index = [rng.randrange(6) for _ in range(50)]  # segment 6 left empty
    got = fr.segment_sum(fr.from_ints(np.array(xs, dtype=object),
                                      device="cpu"),
                         torch.tensor(index), 7)
    want = [sum(x for x, i in zip(xs, index) if i == s) % Q
            for s in range(7)]
    assert [int(v) for v in fr.to_ints(got)] == want


def test_cosets_and_shifts_are_the_specs():
    assert kzg.coset_shifts() == [ref.coset_shift_for_cell(c)
                                  for c in range(kzg.CELLS_PER_EXT_BLOB)]
    seq = list(range(64))
    assert kzg.bit_reversal_permutation(64).tolist() == \
        ref.bit_reversal_permutation(seq)
    # element j of a coset is h_c w64^brp6(j)
    w64 = pow(7, (Q - 1) // 64, Q)
    brp6 = kzg.bit_reversal_permutation(64)
    for c in (0, 1, 77, 127):
        h = ref.coset_shift_for_cell(c)
        assert ref.coset_for_cell(c) == [h * pow(w64, int(brp6[j]), Q) % Q
                                         for j in range(64)]


def test_interpolants_match_lagrange(case):
    batch = case["batch"]
    parsed = kzg._parse(*arrays(batch))
    dec = kzg._decode_device(parsed, "cpu")
    s = case["port"]
    got = fr.to_ints(kzg.interpolants(dec.evals, dec.columns, s.shift_inv,
                                      s.brp6))
    for k, c in enumerate(batch["cell_indices"]):
        want = ref.interpolate_polynomialcoeff(
            ref.coset_for_cell(c), ref.cell_to_coset_evals(batch["cells"][k]))
        assert [int(v) for v in got[k]] == want, k


def test_challenge_bytes_match_the_reference(case):
    batch = with_fault(case["batch"], "wrong_commitment")
    parsed = kzg._parse(*arrays(batch))
    unique = [bytes(u) for u in parsed[0]]
    owner = [unique.index(c) for c in batch["commitments"]]
    assert parsed[1].tolist() == owner
    want = ref.challenge_transcript(
        unique, owner, batch["cell_indices"],
        [ref.cell_to_coset_evals(c) for c in batch["cells"]],
        batch["proofs"])
    assert b"".join(bytes(p) for p in kzg.transcript_chunks(*parsed)) == want
    assert kzg.challenge(*parsed) == ref.compute_challenge(
        unique, owner, batch["cell_indices"],
        [ref.cell_to_coset_evals(c) for c in batch["cells"]],
        batch["proofs"])


def test_transcript_pieces_split_at_hash_rows(monkeypatch, case):
    parsed = kzg._parse(*arrays(case["batch"]))
    whole = b"".join(bytes(p) for p in kzg.transcript_chunks(*parsed))
    monkeypatch.setattr(kzg, "HASH_ROWS", 3)
    pieces = [bytes(p) for p in kzg.transcript_chunks(*parsed)]
    assert b"".join(pieces) == whole
    assert [len(p) // kzg.ROW_BYTES for p in pieces[2:]] == [3, 3, 2]


def test_dedup_keeps_the_order_of_first_appearance():
    rows = np.zeros((6, 48), dtype=np.uint8)
    rows[:, 5] = [9, 2, 9, 4, 2, 9]
    parsed = kzg._parse(rows, np.arange(6), np.zeros((6, 2048), np.uint8),
                        np.zeros((6, 48), np.uint8))
    assert parsed[0][:, 5].tolist() == [9, 2, 4]
    assert parsed[1].tolist() == [0, 1, 0, 2, 1, 0]


def test_spec_assertions_are_false_verdicts(case):
    c, idx, cells, proofs = arrays(case["batch"])
    bad_index = idx.copy()
    bad_index[3] = kzg.CELLS_PER_EXT_BLOB
    spec_cases = [(c[:-1], idx, cells, proofs),          # lengths differ
                  (c, bad_index, cells, proofs),          # index >= 128
                  (c, idx, cells[:, :-1], proofs)]        # a short cell
    # the arrays the public function takes: uint8 rows, integer indices
    type_cases = [(c, idx.astype(np.float64), cells, proofs),
                  (c.astype(np.int32), idx, cells, proofs)]
    before = CELLS.snapshot()
    for args in spec_cases + type_cases:
        assert kzg.verify_cell_kzg_proof_batch(*args, case["port"]) is False
    for args in spec_cases:
        assert ref.verify_cell_kzg_proof_batch(
            [bytes(r) for r in args[0]], [int(i) for i in args[1]],
            [bytes(r) for r in args[2]], [bytes(r) for r in args[3]],
            case["setup"]) is False
    # no cells: the check holds for the identities (the spec's answer)
    assert kzg.verify_cell_kzg_proof_batch(
        c[:0], idx[:0], cells[:0], proofs[:0], case["port"]) is True
    assert ref.verify_cell_kzg_proof_batch([], [], [], [], case["setup"])
    assert CELLS.since(before) == {
        "calls": 6, "cells": 0, "commitments": 0, "refused_decode": 5,
        "refused_pairing": 0, "accepted": 1}


@pytest.mark.parametrize("kind", ["noncanonical", "proof_outside_g1"])
def test_a_decoding_fault_is_refused_by_both(case, kind):
    counts = verdict_matches_reference(case, kind)
    assert counts["refused_decode"] == 1 and counts["cells"] == 8
    assert counts["commitments"] == 2


def test_a_wrong_evaluation_is_refused_by_both(case):
    counts = verdict_matches_reference(case, "wrong_eval")
    assert counts["refused_pairing"] == 1


def test_the_honest_batch_verifies_with_its_spans(case):
    profiling.clear()
    try:
        with autograd_profiler.emit_itt():
            counts = verdict_matches_reference(case, "honest")
        spans = profiling.spans()
    finally:
        profiling.clear()
    assert counts == {"calls": 1, "cells": 8, "commitments": 2,
                      "refused_decode": 0, "refused_pairing": 0,
                      "accepted": 1}
    by_id = {s["id"]: s for s in spans}
    top = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in top] == ["kzg"]
    stages = [s["name"] for s in spans if s["parent"] == top[0]["id"]]
    assert stages == ["kzg.decode", "kzg.challenge", "kzg.interp",
                      "kzg.msm", "kzg.pairing"]
    names = Counter(s["name"] for s in spans)
    assert names["msm"] == 2 and names["codec.decode"] == 1
    assert names["pairing"] == 1 and names["codec.subgroup"] == 1
    for s in spans:
        if s["name"] in ("msm", "codec.decode", "pairing"):
            assert by_id[s["parent"]]["name"] in ("kzg.msm", "kzg.decode",
                                                  "kzg.pairing")
    challenge = next(s for s in spans if s["name"] == "kzg.challenge")
    assert challenge["launches"] == 0 and challenge["stream_ms"] is None
    assert top[0]["start_ns"] <= challenge["start_ns"] <= \
        challenge["end_ns"] <= top[0]["end_ns"]
