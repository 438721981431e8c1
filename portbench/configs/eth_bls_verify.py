"""Driver of `eth_bls_verify`: a consensus client verifying BLS signature
sets (the proof-of-possession ciphersuite, one public key a set).

Inputs, made in set-up from the seed: `batches` x `sets_per_call` sets,
each a 32-byte signing root, a 48-byte compressed public key [sk]G1 and a
96-byte compressed signature [sk]H(m), signed on the card through the
program's scalar multiplication and hash to curve (signing thousands of
sets on the host would take an hour).  In every block of `block` sets, at
four positions drawn from the seed, one signature is of another message,
one is a point outside G2, one has a body bit flipped, and one set has the
identity as its key and its signature (which KeyValidate rejects and the
pairing alone would accept); those sets are invalid, the rest valid.  Call
i verifies batch i % batches through the program's public functions, as a
client would (`verify_batch`), and brings the verdicts to the host.  The
check holds every verdict of the window to the set's label, and a sample
of each kind drawn from the seed to the plain reference's verify of the
same bytes.
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
from reference import bls, hostmath

FR_LIMBS = 16
TOP_LIMB_MASK = 0x3FFF
HONEST, WRONG_MESSAGE, OUTSIDE_G2, FLIPPED_BIT, IDENTITY_KEY = range(5)
KINDS = ("honest", "wrong_message", "outside_g2", "flipped_bit",
         "identity_key")
# the compressed point at infinity: the compression and infinity flags
G1_IDENTITY = bytes([0xC0]) + bytes(47)
G2_IDENTITY = bytes([0xC0]) + bytes(95)
REFERENCE_PROCESSES = 8
REFERENCE_WORKER = Path(__file__).resolve().parent.parent / "verify_worker.py"


def verify_batch(pk_bytes, msgs, sig_bytes, g1_gen, dst, device, spans,
                 pairing_check: bool = True,
                 key_validate: bool = True) -> np.ndarray:
    """Verdicts bool [B] of B signature sets: parse both points with their
    subgroup checks, refuse the identity as a key (KeyValidate), hash the
    messages to G2, one pairing over the 2B lanes [pk | G1] x [H(m) | sig],
    the two halves compared in Gt.  pairing_check=False leaves the
    comparison out (the control); key_validate=False lets the identity key
    through (a fault the check must catch)."""
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.fields import tower
    from bls12_381_torch.hash_to_curve import h2c
    from bls12_381_torch import pairing
    from bls12_381_torch.utils import scans

    n = len(msgs)
    with spans.span("decode_pk"):
        pk_aff, pk_ok = g1.from_compressed_host(pk_bytes, device=device)
    with spans.span("decode_sig"):
        sig_aff, sig_ok = g2.from_compressed_host(sig_bytes, device=device)
    with spans.span("hash_to_curve"):
        h = g2.to_affine(h2c.hash_to_curve_g2(msgs, dst, expand="device",
                                              device=device))
    parsed_np = pk_ok & sig_ok
    if not pairing_check:
        return parsed_np
    with spans.span("pairing"):
        parsed = torch.from_numpy(parsed_np).to(device)
        key_ok = parsed & ~pk_aff[2] if key_validate else parsed
        pk_aff = pk_aff[:2] + (pk_aff[2] | ~parsed,)
        sig_aff = sig_aff[:2] + (sig_aff[2] | ~parsed,)
        ps = scans.tree_map(lambda a, b: torch.cat([a, b], -1), pk_aff,
                            g1_gen)
        qs = scans.tree_map(lambda a, b: torch.cat([a, b], -1), h, sig_aff)
        f = pairing.pairing(ps, qs)
        equal = tower.fp12_eq(scans.tree_map(lambda t: t[..., :n], f),
                              scans.tree_map(lambda t: t[..., n:], f))
    with spans.span("verdict"):
        return (key_ok & equal).cpu().numpy()


def make_sets(config: dict, traffic: dict, seed: int):
    """(msgs, signed, kinds, flips) on the host for every set: the
    messages, the messages actually signed, each set's kind, and each
    flipped set's (byte, bit)."""
    b, k = int(traffic["sets_per_call"]), int(traffic["batches"])
    block = int(traffic["block"])
    n = b * k
    rng = np.random.default_rng(seed % (1 << 64))
    msgs = rng.integers(0, 256, (n, config["message_bytes"]), dtype=np.uint8)
    kinds = np.full(n, HONEST, dtype=np.int8)
    for start in range(0, n, block):
        pos = rng.choice(min(block, n - start), 4, replace=False)
        kinds[start + pos] = (WRONG_MESSAGE, OUTSIDE_G2, FLIPPED_BIT,
                              IDENTITY_KEY)
    signed = msgs.copy()
    wrong = kinds == WRONG_MESSAGE
    signed[wrong] = rng.integers(0, 256, (int(wrong.sum()), msgs.shape[1]),
                                 dtype=np.uint8)
    flipped = np.flatnonzero(kinds == FLIPPED_BIT)
    flips = np.stack([rng.integers(1, 96, flipped.size),
                      rng.integers(0, 8, flipped.size)], -1)
    return msgs, signed, kinds, dict(zip(flipped.tolist(), flips.tolist()))


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 control: bool = False):
        self.config, self.traffic = config, traffic
        self.b = int(traffic["sets_per_call"])
        self.batches = int(traffic["batches"])
        self.dst = config["dst"].encode()
        self.seed, self.control = seed, control
        self.device = torch.device(device)
        self.distinct_inputs = self.batches
        self.spans = devtrace.Spans()

    def setup(self) -> None:
        from bls12_381_torch.curves import g1, g2
        from bls12_381_torch.hash_to_curve import h2c

        dev = self.device
        msgs, signed, kinds, flips = make_sets(self.config, self.traffic,
                                               self.seed)
        n = len(msgs)
        gen = torch.Generator(device=dev).manual_seed(self.seed % (1 << 64))
        sk = torch.randint(0, 1 << 16, (FR_LIMBS, n), generator=gen,
                           device=dev, dtype=torch.int32)
        sk[-1] &= TOP_LIMB_MASK
        pk = g1.to_affine(g1.scalar_mul(g1.generator((n,), dev), sk))
        pk_bytes = g1.to_compressed_host(pk)
        sig = g2.to_affine(g2.scalar_mul(
            h2c.hash_to_curve_g2(signed, self.dst, expand="device",
                                 device=dev), sk))
        sig_bytes = g2.to_compressed_host(sig)
        sig_bytes[kinds == OUTSIDE_G2] = np.frombuffer(
            hostmath.g2_to_compressed(hostmath.g2_point_outside_subgroup()),
            np.uint8)
        for lane, (byte, bit) in flips.items():
            sig_bytes[lane, byte] ^= 1 << bit
        identity = kinds == IDENTITY_KEY
        pk_bytes[identity] = np.frombuffer(G1_IDENTITY, np.uint8)
        sig_bytes[identity] = np.frombuffer(G2_IDENTITY, np.uint8)
        del pk, sig, sk
        self.msgs, self.kinds = msgs, kinds
        self.pk_bytes, self.sig_bytes = pk_bytes, sig_bytes
        self.g1_gen = g1.generator_affine((self.b,), dev)

    def batch(self, j: int):
        s = slice(j * self.b, (j + 1) * self.b)
        return self.pk_bytes[s], self.msgs[s], self.sig_bytes[s]

    def call(self, i: int):
        pk, msgs, sig = self.batch(i % self.batches)
        return verify_batch(pk, msgs, sig, self.g1_gen, self.dst,
                            self.device, self.spans,
                            pairing_check=not self.control), self.b

    def reference_inputs(self):
        return (self.pk_bytes, self.msgs, self.sig_bytes, self.kinds, self.b,
                self.dst, int(self.traffic.get("reference_sample", 1)))

    def release(self) -> None:
        self.g1_gen = None


def check(ref_inputs, answers, seed: int):
    """({name: (value, limit)}, failed call indexes).  wrong_verdicts: the
    window's verdicts that differ from their set's label (valid exactly
    when honest).  reference_disagrees: of `reference_sample` sets of each
    kind drawn from the seed among the batches the window called, those
    whose verdict differs from the plain reference's verify of the same
    bytes.  Both exact, limit 0."""
    pk, msgs, sig, kinds, b, dst, per_kind = ref_inputs
    batches = len(msgs) // b
    valid = kinds == HONEST
    wrong, failed, verdict_of = 0, set(), {}
    for i, verdict in answers:
        j = i % batches
        bad = int((verdict != valid[j * b:(j + 1) * b]).sum())
        wrong += bad
        if bad:
            failed.add(i)
        verdict_of.setdefault(j, verdict)
    called = np.zeros(len(msgs), dtype=bool)
    for j in verdict_of:
        called[j * b:(j + 1) * b] = True
    rng = np.random.default_rng([seed % (1 << 64), 1])
    sample = []
    for kind in range(len(KINDS)):
        lanes = np.flatnonzero(called & (kinds == kind))
        sample += rng.choice(lanes, min(per_kind, lanes.size),
                             replace=False).tolist()
    t0 = time.perf_counter()
    refs = reference_verdicts([(pk[lane].tobytes(), msgs[lane].tobytes(),
                                sig[lane].tobytes(), dst)
                               for lane in sample])
    print(f"reference verify: {len(sample)} sets in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    disagree = sum(ref != bool(verdict_of[lane // b][lane % b])
                   for lane, ref in zip(sample, refs))
    return ({"wrong_verdicts": (wrong, 0),
             "reference_disagrees": (disagree, 0)}, failed)


def reference_verdicts(sets, processes: int | None = None) -> list:
    """`bls.verify` of each (pk, msg, sig, dst).  Where there are more than
    a few sets, over up to REFERENCE_PROCESSES worker processes
    (`verify_worker.py`: they load the reference alone), each
    waited for before it returns, on every path out.  Plain processes and
    pipes, not a multiprocessing pool, whose resource tracker would outlive
    the pool."""
    if processes is None:
        processes = min(REFERENCE_PROCESSES, len(os.sched_getaffinity(0)),
                        len(sets) // 8)
    if processes <= 1:
        return [bls.verify(*s) for s in sets]
    procs = []
    try:
        for k in range(processes):
            procs.append(subprocess.Popen(
                [sys.executable, str(REFERENCE_WORKER)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True))
        # each worker reads all its input before it verifies, and its
        # answer fits a pipe: writing every input first cannot block
        for k, p in enumerate(procs):
            p.stdin.write(json.dumps([[x.hex() for x in s]
                                      for s in sets[k::processes]]))
            p.stdin.close()
        out = [None] * len(sets)
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
