"""The configuration `eth_das_cell_verify`: a Fulu (PeerDAS) supernode in
range sync verifying every cell of an epoch's data column sidecars with
one `verify_cell_kzg_proof_batch` call (`bls12_381_torch.ops.kzg`).

Set-up, from the seed, on the card through the program: tau, the setup's
64 G1 monomial points and [tau^64]G2 (`g1`/`g2.scalar_mul`); per epoch
`blocks` x `blobs_per_block` blob polynomials with coefficients drawn as
Montgomery limbs below 2^254; their cells brp(NTT8192(p)) (`ops/ntt.py`)
in 128 rows of 64, as 32-byte big-endian field elements; commitments
[p(tau)]G1; proofs [(p(tau) - I_c(tau)) / (tau^64 - h_c^64)]G1, I_c =
p mod (X^64 - h_c^64) taken from p's coefficients (`opening_scalars`).
A batch holds an epoch's cells in sidecar order (block, column, blob).
Six invalid batches copy an honest epoch with one fault each, at a
position drawn from the seed (`KINDS`).

Call i verifies batch `cycle[i % 16]`: the two honest epochs first, then
the other 14 (8 honest, 6 invalid) in an order drawn from the seed.  The
check holds every verdict of the window to its batch's label, and one
sub-batch of `reference_sample` cells of each kind (the fault included),
verified by the program outside the window, to the plain reference's
verdict (`reference/kzg.py`, over worker processes).  The control accepts
every batch that decodes (`kzg.decode`): the pairing comparison left out.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import devtrace
from reference import hostmath
from reference.params import Q

FR_LIMBS = 16
LIMB_BITS = 16
TOP_LIMB_MASK = 0x3FFF  # coefficients below 2^254 < q
N_CELL = 64  # FIELD_ELEMENTS_PER_CELL
N_BLOB = 4096  # FIELD_ELEMENTS_PER_BLOB
N_EXT = 8192  # FIELD_ELEMENTS_PER_EXT_BLOB
COLUMNS = N_EXT // N_CELL
CELL_BYTES = 32 * N_CELL
HONEST, WRONG_EVAL, SWAPPED_PROOFS, WRONG_COLUMN, WRONG_COMMITMENT, \
    NONCANONICAL, PROOF_OUTSIDE_G1 = range(7)
KINDS = ("honest", "wrong_eval", "swapped_proofs", "wrong_column",
         "wrong_commitment", "noncanonical", "proof_outside_g1")
REFERENCE_PROCESSES = 8
REFERENCE_WORKER = Path(__file__).resolve().parent.parent \
    / "kzgverify_worker.py"


def fr_ints(values, device):
    from bls12_381_torch.fields import fr

    return fr.from_ints(np.array(values, dtype=object), device=device)


def make_setup(tau: int, device):
    """(kzg.Setup, its points' compressed bytes: 64 G1 and one G2), the
    points [tau^i]G1 and [tau^64]G2 made by the program's scalar
    multiplications."""
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.ops import kzg

    pw = [pow(tau, i, Q) for i in range(N_CELL + 1)]
    g1m = g1.to_affine(g1.scalar_mul(g1.generator((N_CELL,), device),
                                     fr_ints(pw[:N_CELL], device)))
    g2t = g2.to_affine(g2.scalar_mul(g2.generator((1,), device),
                                     fr_ints([pw[N_CELL]], device)))
    return kzg.Setup(g1m, g2t), (g1.to_compressed_host(g1m),
                                 g2.to_compressed_host(g2t))


def be_bytes(mont: torch.Tensor) -> np.ndarray:
    """Montgomery Fr [16, *batch] -> uint8 [*batch, 32] big-endian
    canonical, on the host."""
    from bls12_381_torch import limbs

    c = limbs.from_mont(limbs.FR, mont).movedim(0, -1)
    le = torch.stack([c & 0xFF, c >> 8], dim=-1).reshape(c.shape[:-1] + (32,))
    return le.flip(-1).to(torch.uint8).cpu().numpy()


def opening_scalars(coeffs: torch.Tensor, tau: int):
    """(p(tau) [16, B], the proofs' scalars [16, B, 128]) of blob
    polynomials coeffs [16, B, 4096] (Montgomery): with C[m, j] = c_{64 m +
    j} and S[m] = sum_j C[m, j] tau^j, p(tau) = sum_m tau^(64 m) S[m] and
    I_c(tau) = sum_m a_c^m S[m] (a_c = h_c^64: X^64 = a_c mod the coset's
    vanishing polynomial), the proof's scalar (p(tau) - I_c(tau)) /
    (tau^64 - a_c)."""
    from bls12_381_torch.fields import fr
    from bls12_381_torch.ops import kzg

    dev = coeffs.device
    rows = coeffs.reshape(FR_LIMBS, -1, N_BLOB // N_CELL, N_CELL)
    s = fr.sum_along(fr.mul(rows, fr_ints(
        [pow(tau, j, Q) for j in range(N_CELL)], dev)[:, None, None]), 3)
    t64 = pow(tau, N_CELL, Q)
    p_tau = fr.sum_along(fr.mul(s, fr_ints(
        [pow(t64, m, Q) for m in range(N_BLOB // N_CELL)], dev)[:, None]), 2)
    a = [pow(h, N_CELL, Q) for h in kzg.coset_shifts()]
    a_pow = fr_ints([[pow(v, m, Q) for m in range(N_BLOB // N_CELL)]
                     for v in a], dev)  # [16, 128, 64]
    i_tau = fr.sum_along(fr.mul(s.unsqueeze(2), a_pow.unsqueeze(1)), 3)
    d_inv = fr_ints([pow((t64 - v) % Q, Q - 2, Q) for v in a], dev)
    return p_tau, fr.mul(fr.sub(p_tau.unsqueeze(-1), i_tau), d_inv[:, None])


def make_epoch(blocks: int, blobs: int, tau: int, rng, device) -> dict:
    """One epoch's honest batch on the host: commitments, cell indices,
    cells and proofs of every cell in sidecar order, and each blob's
    commitment (block-major)."""
    from bls12_381_torch.curves import g1
    from bls12_381_torch.ops import kzg, ntt

    n = blocks * blobs
    x = rng.integers(0, 1 << LIMB_BITS, (FR_LIMBS, n, N_BLOB),
                     dtype=np.int32)
    x[-1] &= TOP_LIMB_MASK
    coeffs = torch.from_numpy(x).to(device)
    ext = ntt.ntt(torch.cat([coeffs, torch.zeros_like(coeffs)], dim=-1))
    brp = torch.as_tensor(kzg.bit_reversal_permutation(N_EXT), device=device)
    cells = be_bytes(ext[..., brp]).reshape(blocks, blobs, COLUMNS,
                                            CELL_BYTES)
    del ext
    p_tau, q = opening_scalars(coeffs, tau)
    commit = g1.to_compressed_host(g1.to_affine(g1.scalar_mul(
        g1.generator((n,), device), p_tau)))
    proofs = g1.to_compressed_host(g1.to_affine(g1.scalar_mul(
        g1.generator((n * COLUMNS,), device), q.reshape(FR_LIMBS, -1))))
    proofs = proofs.reshape(blocks, blobs, COLUMNS, 48)
    blob = np.arange(n).reshape(blocks, blobs)
    order = lambda a: np.ascontiguousarray(a.swapaxes(1, 2)).reshape(  # noqa
        blocks * COLUMNS * blobs, -1)
    owner = np.broadcast_to(blob[:, None, :], (blocks, COLUMNS, blobs))
    return {"commitments": commit[owner.reshape(-1)],
            "cell_indices": np.broadcast_to(
                np.arange(COLUMNS)[None, :, None],
                (blocks, COLUMNS, blobs)).reshape(-1).astype(np.uint64),
            "cells": order(cells), "proofs": order(proofs),
            "blob_commitments": commit, "blobs": blobs}


def put_value(cells: np.ndarray, k: int, j: int, v: int) -> None:
    cells[k, 32 * j:32 * (j + 1)] = np.frombuffer(v.to_bytes(32, "big"),
                                                  np.uint8)


def get_value(cells: np.ndarray, k: int, j: int) -> int:
    return int.from_bytes(cells[k, 32 * j:32 * (j + 1)].tobytes(), "big")


def make_fault(epoch: dict, kind: int, rng) -> tuple[dict, list]:
    """A copy of an honest batch with one fault of `kind` at a position
    drawn from rng; returns (batch, the cells the fault touches)."""
    b = {k: (v.copy() if isinstance(v, np.ndarray) else v)
         for k, v in epoch.items()}
    n = b["cell_indices"].shape[0]
    k = int(rng.integers(n))
    j = int(rng.integers(N_CELL))
    touched = [k]
    if kind == WRONG_EVAL:
        v = get_value(b["cells"], k, j)
        put_value(b["cells"], k, j, (v + int(rng.integers(1, 1 << 62))) % Q)
    elif kind == SWAPPED_PROOFS:
        k2 = int(rng.choice(np.delete(np.arange(n), k)))
        b["proofs"][[k, k2]] = b["proofs"][[k2, k]]
        touched.append(k2)
    elif kind == WRONG_COLUMN:
        c = int(b["cell_indices"][k])
        b["cell_indices"][k] = (c + int(rng.integers(1, COLUMNS))) % COLUMNS
    elif kind == WRONG_COMMITMENT:
        blobs = b["blobs"]
        block = k // (COLUMNS * blobs)
        mine = block * blobs + k % blobs
        other = block * blobs + int(rng.choice(
            np.delete(np.arange(blobs), mine - block * blobs)))
        b["commitments"][k] = b["blob_commitments"][other]
    elif kind == NONCANONICAL:
        put_value(b["cells"], k, j, get_value(b["cells"], k, j) + Q)
    elif kind == PROOF_OUTSIDE_G1:
        b["proofs"][k] = np.frombuffer(hostmath.g1_to_compressed(
            hostmath.g1_point_outside_subgroup()), np.uint8)
    else:
        raise ValueError(f"no fault of kind {kind}")
    return b, touched


def sub_batch(batch: dict, lanes) -> tuple:
    """(commitments, cell_indices, cells, proofs) of the given cells."""
    lanes = np.sort(np.asarray(lanes))
    return tuple(batch[k][lanes] for k in
                 ("commitments", "cell_indices", "cells", "proofs"))


def batch_args(batch: dict) -> tuple:
    return (batch["commitments"], batch["cell_indices"], batch["cells"],
            batch["proofs"])


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 control: bool = False):
        self.config, self.traffic = config, traffic
        self.blocks = int(traffic["blocks"])
        self.blobs = int(traffic["blobs_per_block"])
        self.epochs = int(traffic["epochs"])
        self.cells_per_call = self.blocks * self.blobs * COLUMNS
        self.seed, self.control = seed, control
        self.device = torch.device(device)
        self.distinct_inputs = int(traffic["cycle"])
        self.spans = devtrace.Spans()

    def setup(self) -> None:
        rng = np.random.default_rng(self.seed % (1 << 64))
        dev = self.device
        tau = int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62)) \
            % Q
        self.setup_pts, self.setup_bytes = make_setup(tau, dev)
        epochs = [make_epoch(self.blocks, self.blobs, tau, rng, dev)
                  for _ in range(self.epochs)]
        self.batches, self.kinds, self.faults = list(epochs), \
            [HONEST] * self.epochs, [[] for _ in epochs]
        for kind in range(1, len(KINDS)):
            b, touched = make_fault(epochs[kind % self.epochs], kind, rng)
            self.batches.append(b)
            self.kinds.append(kind)
            self.faults.append(touched)
        n_cycle, honest = self.distinct_inputs, int(
            self.traffic["honest_in_cycle"])
        rest = [e % self.epochs for e in range(self.epochs, honest)] + list(
            range(self.epochs, len(self.batches)))
        if len(rest) + self.epochs != n_cycle:
            raise ValueError(f"a cycle of {n_cycle} batches cannot hold "
                             f"{honest} honest and {len(KINDS) - 1} invalid")
        self.cycle = list(range(self.epochs)) + [
            rest[i] for i in rng.permutation(len(rest))]
        from bls12_381_torch.ops import kzg

        if self.control:
            self.verify = lambda *a: kzg.decode(*a, device=dev) is not None
        else:
            self.verify = lambda *a: kzg.verify_cell_kzg_proof_batch(
                *a, self.setup_pts)

    def call(self, i: int):
        with self.spans.span("verify"):
            verdict = self.verify(*batch_args(self.batches[
                self.cycle[i % len(self.cycle)]]))
        return bool(verdict), self.cells_per_call

    def reference_inputs(self):
        """The sub-batches of the reference check, each verified by the
        program here, outside the window."""
        rng = np.random.default_rng([self.seed % (1 << 64), 1])
        per = int(self.traffic["reference_sample"])
        subs, verdicts = [], []
        for kind in range(len(KINDS)):
            b = self.kinds.index(kind)
            touched = self.faults[b]
            n = self.batches[b]["cell_indices"].shape[0]
            rest = np.delete(np.arange(n), touched)
            lanes = list(touched) + rng.choice(
                rest, per - len(touched), replace=False).tolist()
            sub = sub_batch(self.batches[b], lanes)
            subs.append(sub)
            verdicts.append(bool(self.verify(*sub)))
        labels = [self.kinds[b] == HONEST for b in self.cycle]
        return self.setup_bytes, subs, verdicts, labels

    def release(self) -> None:
        self.setup_pts = self.verify = None
        self.batches = None


def check(ref_inputs, answers, seed: int):
    """({name: (value, limit)}, failed call indexes).  wrong_verdicts: the
    window's batches whose verdict differs from their label (valid exactly
    when honest).  reference_disagrees: of the sub-batches of each kind,
    those whose program verdict differs from the plain reference's.  Both
    exact, limit 0."""
    setup_bytes, subs, verdicts, labels = ref_inputs
    wrong, failed = 0, set()
    for i, verdict in answers:
        if verdict != labels[i % len(labels)]:
            wrong += 1
            failed.add(i)
    t0 = time.perf_counter()
    refs = reference_verdicts(setup_bytes, subs)
    print(f"reference verify_cell_kzg_proof_batch: {len(subs)} batches of "
          f"{subs[0][0].shape[0]} cells in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    disagree = sum(r != v for r, v in zip(refs, verdicts))
    return ({"wrong_verdicts": (wrong, 0),
             "reference_disagrees": (disagree, 0)}, failed)


def encode(setup_bytes, subs) -> list:
    """The worker's input: the setup's points and each sub-batch as hex."""
    g1m, g2t = setup_bytes
    return [[g1m.tobytes().hex(), g2t.tobytes().hex()],
            [[c.tobytes().hex(), [int(v) for v in i], x.tobytes().hex(),
              p.tobytes().hex()] for c, i, x, p in subs]]


def reference_verdicts(setup_bytes, subs, processes: int | None = None):
    """The reference's verdict on each sub-batch, sub-batch k on worker
    k mod processes (`kzgverify_worker.py`: plain processes and pipes,
    each waited for on every path out)."""
    if processes is None:
        processes = min(REFERENCE_PROCESSES, len(os.sched_getaffinity(0)),
                        len(subs))
    setup_hex, batches = encode(setup_bytes, subs)
    procs = []
    try:
        for k in range(processes):
            procs.append(subprocess.Popen(
                [sys.executable, str(REFERENCE_WORKER)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True))
        # each worker reads all its input before it verifies, and its
        # answer fits a pipe: writing every input first cannot block
        for k, p in enumerate(procs):
            p.stdin.write(json.dumps([setup_hex, batches[k::processes]]))
            p.stdin.close()
        out = [None] * len(subs)
        for k, p in enumerate(procs):
            answer = p.stdout.read()
            if p.wait() != 0:
                raise RuntimeError(f"reference worker {k} exited with "
                                   f"{p.returncode}")
            out[k::processes] = json.loads(answer)
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            for f in (p.stdin, p.stdout):
                if not f.closed:
                    f.close()
