"""Driver of `eth_aggregate_verify`: an Electra consensus client in range
sync verifying every aggregate signature of an epoch with
FastAggregateVerify over its validator pubkey cache, which lives on the
card (`bls12_381_torch.ops.aggregate.KeyRegistry`).

Set-up, from the seed: `registry_keys` secret keys (16-bit limbs x below
2^254, read as Montgomery Fr: the key is [x R^-1]G1), their public keys
by the program's scalar multiplication on the card, compressed, and
loaded through `KeyRegistry.register`, which must take every one.
`active_keys` of the entries are active.  Each epoch a seeded permutation
of them gives each slot's committee members (`make_epochs`); a block of
the epoch holds 11 sets: the proposer's signature and RANDAO reveal (one
key each), the traffic's attestations over the slot's members, and the
sync aggregate.  In every `block` sets, at positions drawn from the seed,
five are invalid: a signature of another message, a signature over the
set's keys but one, a point outside G2, a flipped body bit, and a one-key
set that becomes {pk, -pk} (an inactive entry given the negated secret)
with the identity as signature.  Each set's signature [sum x_i mod q]
H(m) is made on the card.

Call i verifies epoch i % epochs (`verify_epoch`): the key sums of every
set from the registry, KeyValidate of each sum, the signatures parsed,
the messages hashed to G2, one pairing over 2S lanes, the verdicts to the
host.  The check holds every verdict of the window to its set's label,
and a sample of every kind and set size drawn from the seed to the plain
reference's FastAggregateVerify of the same bytes.
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
from reference import aggregate, hostmath
from reference.params import Q

FR_LIMBS = 16
LIMB_BITS = 16
TOP_LIMB_MASK = 0x3FFF  # x < 2^254 < q
KEYGEN_CHUNK = 1 << 18  # keys made a launch sequence
HONEST, WRONG_MESSAGE, MISSING_KEY, OUTSIDE_G2, FLIPPED_BIT, \
    IDENTITY_AGGREGATE = range(6)
KINDS = ("honest", "wrong_message", "missing_key", "outside_g2",
         "flipped_bit", "identity_aggregate")
# the compressed point at infinity: the compression and infinity flags
G2_IDENTITY = bytes([0xC0]) + bytes(95)
REFERENCE_PROCESSES = 8
REFERENCE_WORKER = Path(__file__).resolve().parent.parent \
    / "aggverify_worker.py"


def verify_epoch(registry, indices, offsets, msgs, sig_bytes, g1_gen, dst,
                 device, spans, pairing_check: bool = True,
                 key_validate: bool = True) -> np.ndarray:
    """Verdicts bool [S] of S FastAggregateVerify sets: the keys of set s
    are registry entries indices[offsets[s]:offsets[s + 1]].  Their sums
    (one gather and segmented sum), KeyValidate of each sum (a non-empty
    set, not the identity), the signatures parsed with their subgroup
    check, the messages hashed to G2, one pairing over the 2S lanes
    [apk | G1] x [H(m) | sig], the halves compared in Gt.
    pairing_check=False leaves the comparison out (the control);
    key_validate=False lets an identity sum through (a fault the check
    must catch)."""
    from bls12_381_torch import pairing
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.fields import tower
    from bls12_381_torch.hash_to_curve import h2c
    from bls12_381_torch.utils import scans

    n = len(msgs)
    with spans.span("aggregate"):
        apk, filled = registry.aggregate(indices, offsets)
        key_ok = filled & ~g1.is_identity(apk) if key_validate else filled
        apk_aff = g1.to_affine(apk)
    with spans.span("decode_sig"):
        sig_aff, sig_ok = g2.from_compressed_host(sig_bytes, device=device)
    with spans.span("hash_to_curve"):
        h = g2.to_affine(h2c.hash_to_curve_g2(msgs, dst, expand="device",
                                              device=device))
    if not pairing_check:
        return sig_ok & key_ok.cpu().numpy()
    with spans.span("pairing"):
        parsed = torch.from_numpy(sig_ok).to(device)
        sig_aff = sig_aff[:2] + (sig_aff[2] | ~parsed,)
        ps = scans.tree_map(lambda a, b: torch.cat([a, b], -1), apk_aff,
                            g1_gen)
        qs = scans.tree_map(lambda a, b: torch.cat([a, b], -1), h, sig_aff)
        f = pairing.pairing(ps, qs)
        equal = tower.fp12_eq(scans.tree_map(lambda t: t[..., :n], f),
                              scans.tree_map(lambda t: t[..., n:], f))
    with spans.span("verdict"):
        return (parsed & key_ok & equal).cpu().numpy()


def make_epochs(traffic: dict, seed: int) -> dict:
    """The sets of every epoch on the host, from the seed: `sets` (each a
    sorted int array of registry indices, epoch after epoch), `kinds`,
    `msgs` and `signed` (the message each set's signature is over),
    `dropped` (set -> the key its signature leaves out), `negated`
    (inactive entry j -> the key i it negates, x_j = q - x_i) and `flips`
    (set -> (byte, bit))."""
    n_reg, n_act = int(traffic["registry_keys"]), int(traffic["active_keys"])
    slots = int(traffic["slots_per_epoch"])
    atts = [int(a) for a in traffic["attestations"]]
    members = n_act // slots
    if sum(atts) > members:
        raise ValueError(f"attestations of {sum(atts)} keys exceed a "
                         f"slot's {members} members")
    rng = np.random.default_rng(seed % (1 << 64))
    entries = rng.permutation(n_reg)
    active, inactive = entries[:n_act], list(entries[n_act:])
    sync = rng.choice(active, int(traffic["sync_committee"]), replace=False)
    sets = []
    for _ in range(int(traffic["epochs"])):
        shuffled = rng.permutation(active)
        for s in range(slots):
            proposer = np.array([rng.choice(active)])
            attesting = rng.permutation(
                shuffled[s * members:(s + 1) * members])[:sum(atts)]
            sets += [proposer, proposer.copy()]
            sets += [np.sort(part) for part in
                     np.split(attesting, np.cumsum(atts)[:-1])]
            sets.append(np.sort(rng.choice(
                sync, int(traffic["sync_participants"]), replace=False)))

    n, block = len(sets), int(traffic["block"])
    kinds = np.full(n, HONEST, dtype=np.int8)
    for start in range(0, n, block):
        lanes = np.arange(start, min(start + block, n))
        one_key = lanes[[len(sets[i]) == 1 for i in lanes]]
        if one_key.size == 0 or lanes.size < 5:
            raise ValueError(f"sets {start}.. hold no one-key set or fewer "
                             "than five sets")
        ident = rng.choice(one_key)
        kinds[ident] = IDENTITY_AGGREGATE
        kinds[rng.choice(lanes[lanes != ident], 4, replace=False)] = (
            WRONG_MESSAGE, MISSING_KEY, OUTSIDE_G2, FLIPPED_BIT)
    negated = {}
    for i in np.flatnonzero(kinds == IDENTITY_AGGREGATE):
        j = inactive.pop(int(rng.integers(len(inactive))))
        negated[int(j)] = int(sets[i][0])
        sets[i] = np.sort(np.array([sets[i][0], j]))
    msgs = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    signed = msgs.copy()
    wrong = kinds == WRONG_MESSAGE
    signed[wrong] = rng.integers(0, 256, (int(wrong.sum()), 32),
                                 dtype=np.uint8)
    dropped = {int(i): int(rng.integers(len(sets[i])))
               for i in np.flatnonzero(kinds == MISSING_KEY)}
    flipped = np.flatnonzero(kinds == FLIPPED_BIT)
    flips = {int(i): (int(rng.integers(1, 96)), int(rng.integers(0, 8)))
             for i in flipped}
    return {"sets": [s.astype(np.int32) for s in sets], "kinds": kinds,
            "msgs": msgs, "signed": signed, "dropped": dropped,
            "negated": negated, "flips": flips}


def limb_value(limbs) -> int:
    return sum(int(v) << (LIMB_BITS * k) for k, v in enumerate(limbs))


def value_limbs(v: int) -> list:
    return [(v >> (LIMB_BITS * k)) & 0xFFFF for k in range(FR_LIMBS)]


def secret_keys(n: int, negated: dict, seed: int) -> np.ndarray:
    """int64 [n, 16]: each entry's secret as Montgomery Fr limbs x < 2^254
    (the scalar x R^-1 mod q), drawn from the seed; an entry j of
    `negated` holds q - x_i, so its key is the negation of key i's."""
    rng = np.random.default_rng([seed % (1 << 64), 2])
    x = rng.integers(0, 1 << LIMB_BITS, (n, FR_LIMBS), dtype=np.int64)
    x[:, -1] &= TOP_LIMB_MASK
    for j, i in negated.items():
        x[j] = value_limbs(Q - limb_value(x[i]))
    return x


def set_secrets(x: np.ndarray, epochs: dict) -> list:
    """Each set's signing scalar sum_i x_i mod q over its keys, the key of
    `dropped` left out, as ints: per limb column, prefix sums over the
    sets' keys back to back (exact in int64: 2^21 keys x 2^16)."""
    sets = epochs["sets"]
    offsets = np.concatenate([[0], np.cumsum([len(s) for s in sets])])
    prefix = np.zeros((offsets[-1] + 1, FR_LIMBS), dtype=np.int64)
    np.cumsum(x[np.concatenate(sets)], axis=0, out=prefix[1:])
    sums = prefix[offsets[1:]] - prefix[offsets[:-1]]
    out = []
    for i, row in enumerate(sums):
        v = limb_value(row)
        if i in epochs["dropped"]:
            v -= limb_value(x[sets[i][epochs["dropped"][i]]])
        out.append(v % Q)
    return out


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 control: bool = False):
        self.config, self.traffic = config, traffic
        self.epochs = int(traffic["epochs"])
        self.sets_per_epoch = int(traffic["slots_per_epoch"]) * (
            3 + len(traffic["attestations"]))
        self.dst = config["dst"].encode()
        self.seed, self.control = seed, control
        self.device = torch.device(device)
        self.distinct_inputs = self.epochs
        self.spans = devtrace.Spans()

    def setup(self) -> None:
        from bls12_381_torch.curves import g1, g2
        from bls12_381_torch.hash_to_curve import h2c
        from bls12_381_torch.ops import aggregate as agg

        dev = self.device
        ep = make_epochs(self.traffic, self.seed)
        n_reg = int(self.traffic["registry_keys"])
        x = secret_keys(n_reg, ep["negated"], self.seed)
        parts = []
        for lo in range(0, n_reg, KEYGEN_CHUNK):
            sk = torch.from_numpy(x[lo:lo + KEYGEN_CHUNK].T.astype(np.int32)
                                  .copy()).to(dev)
            pk = g1.scalar_mul(g1.generator((sk.shape[1],), dev), sk)
            parts.append(g1.to_compressed_host(g1.to_affine(pk)))
        self.pk_bytes = np.concatenate(parts)
        self.registry = agg.KeyRegistry(dev)
        taken = self.registry.register(self.pk_bytes)
        if not taken.all():
            raise RuntimeError(f"the registry refused {(~taken).sum()} keys")

        y = set_secrets(x, ep)
        y_limbs = torch.tensor([value_limbs(v) for v in y],
                               dtype=torch.int32).T.contiguous().to(dev)
        sig = g2.to_affine(g2.scalar_mul(
            h2c.hash_to_curve_g2(ep["signed"], self.dst, expand="device",
                                 device=dev), y_limbs))
        sig_bytes = g2.to_compressed_host(sig)
        kinds = ep["kinds"]
        sig_bytes[kinds == OUTSIDE_G2] = np.frombuffer(
            hostmath.g2_to_compressed(hostmath.g2_point_outside_subgroup()),
            np.uint8)
        for i, (byte, bit) in ep["flips"].items():
            sig_bytes[i, byte] ^= 1 << bit
        sig_bytes[kinds == IDENTITY_AGGREGATE] = np.frombuffer(G2_IDENTITY,
                                                               np.uint8)
        self.set_keys, self.kinds = ep["sets"], kinds
        self.msgs, self.sig_bytes = ep["msgs"], sig_bytes
        self.inputs = [self.epoch_inputs(e) for e in range(self.epochs)]
        self.g1_gen = g1.generator_affine((self.sets_per_epoch,), dev)

    def epoch_inputs(self, e: int):
        """(indices, offsets, msgs, signatures) of epoch e on the host."""
        s = slice(e * self.sets_per_epoch, (e + 1) * self.sets_per_epoch)
        keys = self.set_keys[s]
        offsets = np.concatenate([[0], np.cumsum([len(k) for k in keys])])
        return np.concatenate(keys), offsets, self.msgs[s], self.sig_bytes[s]

    def call(self, i: int):
        verdicts = verify_epoch(self.registry, *self.inputs[i % self.epochs],
                                self.g1_gen, self.dst, self.device,
                                self.spans, pairing_check=not self.control)
        return verdicts, self.sets_per_epoch

    def reference_inputs(self):
        return (self.pk_bytes, self.set_keys, self.msgs, self.sig_bytes,
                self.kinds, self.sets_per_epoch, self.dst,
                int(self.traffic.get("reference_sample", 1)))

    def release(self) -> None:
        self.registry = self.g1_gen = None


def check(ref_inputs, answers, seed: int):
    """({name: (value, limit)}, failed call indexes).  wrong_verdicts: the
    window's verdicts that differ from their set's label (valid exactly
    when honest).  reference_disagrees: of `reference_sample` sets of each
    kind and set size drawn from the seed among the epochs the window
    called, those whose verdict differs from the plain reference's
    FastAggregateVerify of the same bytes.  Both exact, limit 0."""
    pk, set_keys, msgs, sig, kinds, per_epoch, dst, per_group = ref_inputs
    epochs = len(msgs) // per_epoch
    valid = kinds == HONEST
    wrong, failed, verdict_of = 0, set(), {}
    for i, verdict in answers:
        e = i % epochs
        bad = int((verdict != valid[e * per_epoch:(e + 1) * per_epoch]).sum())
        wrong += bad
        if bad:
            failed.add(i)
        verdict_of.setdefault(e, verdict)
    sizes = np.array([len(k) for k in set_keys])
    called = np.zeros(len(msgs), dtype=bool)
    for e in verdict_of:
        called[e * per_epoch:(e + 1) * per_epoch] = True
    rng = np.random.default_rng([seed % (1 << 64), 1])
    sample = []
    for kind in range(len(KINDS)):
        for size in np.unique(sizes[kinds == kind]):
            lanes = np.flatnonzero(called & (kinds == kind) & (sizes == size))
            sample += rng.choice(lanes, min(per_group, lanes.size),
                                 replace=False).tolist()
    # the largest sets first: spread over the workers one by one
    sample.sort(key=lambda lane: -sizes[lane])
    t0 = time.perf_counter()
    refs = reference_verdicts([(pk[set_keys[lane]].tobytes(),
                                msgs[lane].tobytes(), sig[lane].tobytes(),
                                dst) for lane in sample])
    print(f"reference FastAggregateVerify: {len(sample)} sets, "
          f"{int(sizes[sample].sum())} keys in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    disagree = sum(ref != bool(verdict_of[lane // per_epoch]
                               [lane % per_epoch])
                   for lane, ref in zip(sample, refs))
    return ({"wrong_verdicts": (wrong, 0),
             "reference_disagrees": (disagree, 0)}, failed)


def reference_verdict(keys: bytes, msg: bytes, sig: bytes, dst: bytes):
    """`aggregate.fast_aggregate_verify` of one set, its keys' 48-byte
    encodings back to back (as `aggverify_worker.py` reads them)."""
    return aggregate.fast_aggregate_verify(
        [keys[k:k + 48] for k in range(0, len(keys), 48)], msg, sig, dst)


def reference_verdicts(sets, processes: int | None = None) -> list:
    """`reference_verdict` of each (keys, msg, sig, dst).  Where there are
    more than a few sets, over up to REFERENCE_PROCESSES worker processes
    (`aggverify_worker.py`: they load the reference alone), set k to
    worker k mod processes, each waited for before it returns, on every
    path out.  Plain processes and pipes, not a multiprocessing pool,
    whose resource tracker would outlive the pool."""
    if processes is None:
        processes = min(REFERENCE_PROCESSES, len(os.sched_getaffinity(0)),
                        len(sets))
    if processes <= 1:
        return [reference_verdict(*s) for s in sets]
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
