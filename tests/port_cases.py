"""Launch schedules, case lists and host helpers that the port's tests
share: plain Python over `bls12_381_torch`, torch and numpy, nothing of the
JAX package (`tests/test_torch_imports.py` checks this), and no card.

  - `expected_*_launches`: the kernel launches of one call of a path, by
    kernel (and the plans by name), from the static schedules of the
    modules; the CPU tests hold them to the plain versions' calls counted
    (`test_torch_smul.count_launches`), the `gpu` tests to the card's
    `LAUNCHES` counts;
  - the case lists of the hash kernels, the codecs' rejects, the hash to
    curve KATs' DSTs, the Fp2 power's edge lanes;
  - host helpers: points and Fp12 values as Python ints, the host's
    [sum_i k_i (i+1)]G of `entry.msm_inputs`, the BLS round trip through
    the public functions;
  - the sharded paths' rank job (`parallel_job`) and its spawner, which
    the CPU test runs on gloo ranks and the card test on cuda:0.
"""

from __future__ import annotations

import collections
import math
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
VECTORS = ROOT / "tests" / "vectors"
SEED = 20261016
BATCH = 1024                       # the pairing's batch of the card checks
MSM_HOST_BLOCK = 1 << 20           # lanes per numpy dot of the host oracle
# the scalar multiplication, subgroup and normalization rows: (group,
# function, lanes)
SMUL_ROWS = (("g1", "scalar_mul", 1 << 10), ("g1", "scalar_mul", 1 << 12),
             ("g2", "scalar_mul", 1 << 10),
             ("g1", "is_torsion_free", 1 << 12),
             ("g2", "is_torsion_free", 1 << 12),
             ("g1", "clear_cofactor", 1 << 12),
             ("g2", "clear_cofactor", 1 << 12),
             ("gt", "scalar_mul", 1 << 10),
             ("g1", "batch_normalize", 10000),
             ("g2", "batch_normalize", 10000))
BAD_LANE = 17                      # lanes i % 64 == 17: outside G1 / G2
FP2_EDGE_LANES = ("0", "0"), ("1", "0"), ("0", "1"), ("p-1", "p-1"), \
    ("0", "p-1"), ("p-1", "0"), ("p-1", "1"), ("1", "p-1"), ("R", "0")
# sqr (mont_sqr.cuh): one lane, a partial block, the decompression's and
# h2c's widths, the card full and 2^20 (held on sampled lanes)
SQR_WIDTHS = (1, 33, 1024, 1 << 16, 1 << 20)
CODEC_FORMS = ("compressed", "uncompressed")
H2C_LOG_N = 8                      # the hash to curve rows at batch 256
H2C_ROWS = (("g1", "hash"), ("g2", "hash"), ("g1", "encode"),
            ("g2", "encode"))
# draft-16's test DSTs of the hash-to-curve KATs in tests/vectors/h2c_kats.json
KAT_DSTS = {
    "g1_ro": b"QUUX-V01-CS02-with-BLS12381G1_XMD:SHA-256_SSWU_RO_",
    "g1_nu": b"QUUX-V01-CS02-with-BLS12381G1_XMD:SHA-256_SSWU_NU_",
    "g2_ro": b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_",
    "g2_nu": b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_NU_",
}
# the proof-of-possession suite, minimal public-key size (pk in G1)
BLS_DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"
BLS_WRONG_MESSAGE, BLS_FLIPPED_BIT, BLS_OUTSIDE_G2 = 3, 7, 11  # lanes i % 64
ORACLE_G2_LANES = 16               # host hash_to_curve_g2: ~0.5 s a lane
ORACLE_TERMS = 8                   # the multi-pairing's terms
ORACLE_FR_LOG_N = 10
ORACLE_CODEC_LOG_N = 16            # the native Fp codec's rows
# the sharded paths: their window, and PARALLEL_RANKS ranks on the 1-D and
# the 2 x PARALLEL_RANKS/2 meshes
PARALLEL_RANKS = 4
PARALLEL_WINDOW = 12
# shard_batch's axis_name choices on the 2 x 2 mesh, and the keys of
# parallel_job's result that are not rows
SHARD_AXES = (None, "host", "x", ("host", "x"), ("x", "host"))
NOT_ROWS = ("entry", "shards")
PARALLEL_KINDS = ("pairing_agg_fe", "pairing_agg", "pairing", "msm_g1",
                  "msm_g2", "intt", "ntt")
# the hash kernels' cases: XMD message lengths that put b0 across one, two
# and three blocks, output lengths to ell = 255, DSTs to one over 255 bytes
# (reduced on the host)
HASH_DST = b"BENCH-DST_"            # entry.H2C_DST
XMD_MSG_LENS = (0, 1, 32, 55, 56, 63, 64, 119, 120, 200)
XMD_OUT_LENS = (32, 33, 36, 48, 64, 128, 256, 8160)  # 33, 36: stores of 1, 4
XMD_DST_LENS = (1, 10, 43, 255, 300)
SHAKE_RATES = (136, 168)


def xmd_cases():
    """(msg_len, len_in_bytes, dst_len) of the XMD kernel's cases: every
    message length at hash_to_curve_g2's 256 bytes under the bench DST (b0
    over one, two and three blocks), every output length under BLS_DST and
    every DST length at 256 bytes (300: reduced on the host), these with
    32-byte messages, and the other hash to curve rows' 32 bytes to 128 and
    to 64 under the bench DST."""
    d10 = len(HASH_DST)
    cases = [(m, 256, d10) for m in XMD_MSG_LENS]
    cases += [(32, n, len(BLS_DST)) for n in XMD_OUT_LENS]
    cases += [(32, 256, d) for d in XMD_DST_LENS]
    cases += [(32, 128, d10), (32, 64, d10)]
    return list(dict.fromkeys(cases))


def shake_cases():
    """(rate, msg_len, out_len) of the SHAKE kernel's cases: messages of 0,
    r-1, r, r+1 and 2r bytes and outputs of 1, r, r+1 and 512 bytes at both
    rates."""
    return [(r, m, o) for r in SHAKE_RATES
            for m in (0, r - 1, r, r + 1, 2 * r) for o in (1, r, r + 1, 512)]


def load_points(a_idx, b_idx):
    """Affine G1 [a]G1 and G2 [b]G2 from the uncompressed test vectors
    (entry i is [i]G; entry 0 the identity)."""
    g1 = (VECTORS / "g1_uncompressed_valid_test_vectors.dat").read_bytes()
    g2 = (VECTORS / "g2_uncompressed_valid_test_vectors.dat").read_bytes()

    def fe(raw):
        return int.from_bytes(raw, "big")

    def g1_at(i):
        e = g1[96 * i: 96 * i + 96]
        if e[0] & 0x40:
            return (0, 0, True)
        return (fe(bytes([e[0] & 0x1F]) + e[1:48]), fe(e[48:96]), False)

    def g2_at(i):
        e = g2[192 * i: 192 * i + 192]
        if e[0] & 0x40:
            return ((0, 0), (0, 0), True)
        x1 = fe(bytes([e[0] & 0x1F]) + e[1:48])
        return ((fe(e[48:96]), x1), (fe(e[144:192]), fe(e[96:144])), False)

    return [g1_at(i) for i in a_idx], [g2_at(i) for i in b_idx]


def encode(ps, qs, device):
    import torch

    from bls12_381_torch.fields import fp, tower as tw

    p_aff = (fp.from_ints([p[0] for p in ps], device=device),
             fp.from_ints([p[1] for p in ps], device=device),
             torch.tensor([p[2] for p in ps], device=device))
    q_aff = (tw.fp2_from_ints([q[0] for q in qs], device=device),
             tw.fp2_from_ints([q[1] for q in qs], device=device),
             torch.tensor([q[2] for q in qs], device=device))
    return p_aff, q_aff


def zero_launches() -> dict:
    """Every key of `LAUNCHES.snapshot()` at 0: the base of each schedule
    below, so that a schedule names every counter a run reads."""
    from bls12_381_torch.kernels import LaunchCounts

    return LaunchCounts().snapshot()


def expected_launches():
    """The launches of one pairing by kernel, from the static schedules
    (its plans are not counted by name)."""
    import importlib

    from bls12_381_torch.fields import tower as tw

    pm = importlib.import_module("bls12_381_torch.pairing.pairing")
    k = tw.CYCLO_FUSE
    per_exp_z = sum(n // k + n % k + (1 if mul else 0)
                    for n, mul in pm._X_RUNS)
    # final exp outside the five exp-by-|z|: 10 fp12_mul + 1 fp12_sqr
    plans = 2 * pm.N_COEFFS + 5 * per_exp_z + 11
    # folds (fold_planned): the Miller loop's line scaling; in fp12_inv two
    # fp6_mul_many, fp6_inv's three folds and fp2_inv's two products; three
    # per fp12_frobenius, eight of them in the final exponentiation
    folds = 1 + 5 + 1 + 3 * 8
    # fp2_inv in fp12_inv: the norm (one sop) and its fp.inv, one
    # pow_fixed (no sqr chain)
    out = zero_launches()
    del out["plan_exec_by_plan"]
    return {**out, "plan_exec": plans, "sop": 1, "fold_planned": folds,
            "pow_fixed": 1}


def pairing_inputs(device):
    """The pairing's batch: [a]G1, [b]G2 with a, b < 1000 from the seed,
    fixed lanes first (e(G1, G2), identities, equal products)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    a_idx = [int(v) for v in rng.integers(0, 1000, BATCH)]
    b_idx = [int(v) for v in rng.integers(0, 1000, BATCH)]
    fixed = [(1, 1), (0, 5), (7, 0), (0, 0), (2, 3), (3, 2), (6, 1), (1, 6),
             (10, 20), (20, 10), (40, 5)]
    for lane, (a, b) in enumerate(fixed):
        a_idx[lane], b_idx[lane] = a, b
    return (a_idx, b_idx) + encode(*load_points(a_idx, b_idx), device)


def limb_ints(t) -> list:
    """[16, n] Fr limbs (any device) -> n Python ints, as stored (the
    Montgomery values), through little-endian bytes."""
    import numpy as np

    raw = np.ascontiguousarray(t.cpu().numpy().astype("<u2").T).tobytes()
    return [int.from_bytes(raw[i:i + 32], "little")
            for i in range(0, len(raw), 32)]


def expected_ntt_launches(n: int, inverse: bool) -> dict:
    """Kernel launches of one transform of N = n lanes, from the schedule
    of ops/ntt.py: one `butterfly` per stage (log2 N stages); the twiddle
    table doubles from 1 to N/2 columns, one `sop_fr` per doubling
    (log2 N - 1); the inverse adds one `sop_fr` for the 1/N scaling."""
    log_n = n.bit_length() - 1
    return {**zero_launches(), "butterfly": log_n,
            "sop_fr": log_n - 1 + int(inverse)}


def expected_msm_launches(group: str, n: int, c: int, split: bool = True,
                          fold: bool = False):
    """Kernel launches of one msm over n >= 16 points with window c, from
    the schedule of ops/msm.py: from_mont of the scalars (one sop_fr); the
    z inversions of to_affine (`batch_inv`: two product scans of 2 lg n
    products, one Fp inversion (one pow_fixed), two products; G2 adds the
    norm, one sop, and two products, one fold) and its x, y products (one
    fold_planned);
    the GLV split's beta x (one sop) or the GLS split's three psi (one
    fold of two Fp2 products each); then the bucket sums: per window of
    the signed digits the segmented scan (2 lg m adds over m lanes), or on
    a card (fold=True) one fold over every window's lanes, a launch of the
    plan kernel's fold mode a level (`msm.fold_levels`), the first with
    the mixed addition's plan; per window the bucket sum (a suffix scan
    and a halving tree over 2^(c-1) buckets: 3 (c - 1) adds), c doublings
    and one add."""
    from bls12_381_torch.ops import msm

    def lg(m):
        return (m - 1).bit_length()

    inv = 4 * lg(n) + 2
    lanes, bits = {("g1", True): (2 * n, 128), ("g2", True): (4 * n, 64)}.get(
        (group, split), (n, 255))
    windows = -(-(bits + 1) // c)
    adds = windows * (3 * (c - 1) + 1)
    by_plan = collections.Counter({f"{group}_double_plan": windows * c})
    if fold:
        levels = len(msm.fold_levels(windows * lanes))
        by_plan.update({f"{group}_add_mixed_plan[fold]": 1,
                        f"{group}_add_plan[fold]": levels - 1})
    else:
        adds += windows * 2 * lg(lanes)
    by_plan[f"{group}_add_plan"] += adds
    if group == "g1":
        sops, folds = inv + int(split), 1
    else:
        sops, folds = 1 + inv, 2 + (3 if split else 0)
    return {**zero_launches(), "sop": sops,
            "plan_exec": sum(by_plan.values()), "sop_fr": 1,
            "fold_planned": folds, "pow_fixed": 1,
            "plan_exec_by_plan": {k: v for k, v in by_plan.items() if v}}


def expected_msm_large_launches(n: int, c: int, chunk_log2: int = 21,
                                fold: bool = False):
    """Kernel launches of one msm_g1_large over n >= 16 points with window
    c: msm_g1's schedule (`expected_msm_launches`, the fold's with
    fold=True) per chunk of 2^chunk_log2 points, the last one as long as
    what is left, and one g1_add at one lane per chunk after the first (the
    fold of the chunks)."""
    cs = 1 << chunk_log2
    parts = [expected_msm_launches("g1", min(cs, n - i), c, fold=fold)
             for i in range(0, n, cs)]
    out = {k: sum(p[k] for p in parts) for k in parts[0]
           if k != "plan_exec_by_plan"}
    by_plan = collections.Counter()
    for p in parts:
        by_plan.update(p["plan_exec_by_plan"])
    out["plan_exec"] += len(parts) - 1
    by_plan["g1_add_plan"] += len(parts) - 1
    out["plan_exec_by_plan"] = dict(by_plan)
    return out


def msm_host_sum(sc, skip) -> int:
    """sum_i k_i (i+1) mod q over the lanes where `skip` (numpy bool [N])
    is false, for Montgomery Fr scalars sc [16, N] on any device, without a
    Python int per lane: the Montgomery values are linear in the canonical
    ones, so S = sum_k 2^(16 k) sum_i limb_k[i] w_i (w_i = i + 1, 0 where
    skipped) as numpy uint64 dot products over blocks of MSM_HOST_BLOCK
    lanes (each below 2^16 2^25 2^20 = 2^61 up to N = 2^24), summed as
    Python ints, then S R^-1 mod q."""
    import numpy as np

    from bls12_381_torch import params

    lim = sc.cpu().numpy()
    n = lim.shape[-1]
    if n > 1 << 24 or lim.min() < 0 or lim.max() >= 1 << 16:
        raise ValueError("msm_host_sum: expected 16-bit limbs over at most "
                         "2^24 lanes")
    total = 0
    for b0 in range(0, n, MSM_HOST_BLOCK):
        b1 = min(n, b0 + MSM_HOST_BLOCK)
        w = np.arange(b0 + 1, b1 + 1, dtype=np.uint64)
        w[skip[b0:b1]] = 0
        for k in range(lim.shape[0]):
            total += int(np.dot(lim[k, b0:b1].astype(np.uint64), w)) \
                << (16 * k)
    return total * pow(1 << 256, -1, params.Q) % params.Q


def affine_ints(group: str, point):
    """A projective point with an empty batch shape -> host affine ints
    (None for the identity), through the port's to_affine."""
    from bls12_381_torch.utils import scans

    return affine_lanes(group, scans.tree_map(lambda t: t.unsqueeze(-1),
                                              point), [0])[0]


def expected_smul_launches(group: str, name: str, n: int) -> dict:
    """Kernel launches of one call of a row of SMUL_ROWS over n >= 16 lanes,
    from the static schedules of curves/, pairing/gt.py and limbs.py:
      - scalar_mul: from_mont of the scalars (one sop_fr); tables of
        identity, P, ..., 8P per point (7 adds; Gt: 16 entries, 14
        products), then per 4-bit digit step 4 doublings (Gt: one
        fp12_cyclotomic_sqr_k(4)) and one add per point: G1 two points
        over 33 steps, beta x (one sop); G2 four over 17, three psi (one
        fold each); Gt four over 16, three Frobenius maps (three folds
        each);
      - mul_by_const(k): a doubling per bit of k, an add per set bit;
        is_torsion_free: G1 two [|z|] chains, beta x, the fold of eq; G2
        one chain, psi, the fold of eq; clear_cofactor: G1 [h_eff], G2
        three chains, five adds, a doubling, three psi;
      - batch_normalize: the z inversions (`batch_inv`: two product scans
        of 2 lg n products, one pow_fixed, two products; G2 first the norm,
        one sop) and the x, y products (one fold; G2 one more for
        fp2_batch_inv's two products)."""
    from bls12_381_torch import params

    def lg(m):
        return (m - 1).bit_length()

    x = params.BLS_X
    out = zero_launches()
    plans = {}

    def plan(what, k):
        key = {"add": f"{group}_add_plan", "double": f"{group}_double_plan",
               "mul": "fp12_mul_plan",
               "sqr4": "fp12_cyclotomic_sqr_k_plan(4)"}[what]
        plans[key] = plans.get(key, 0) + k

    def mul_by_const(k):
        plan("double", k.bit_length())
        plan("add", bin(k).count("1"))

    if name == "scalar_mul":
        out["sop_fr"] = 1
        if group == "gt":
            steps = 64 // 4
            out["fold_planned"] = 3 * 3
            plan("mul", 4 * 14 + 4 * steps)
            plan("sqr4", steps)
        else:
            points, bits = {"g1": (2, 128), "g2": (4, 64)}[group]
            steps = -(-(bits + 1) // 4)
            out["sop" if group == "g1" else "fold_planned"] = \
                1 if group == "g1" else 3
            plan("add", points * 7 + points * steps)
            plan("double", 4 * steps)
    elif name == "is_torsion_free":
        for _ in range({"g1": 2, "g2": 1}[group]):
            mul_by_const(x)
        if group == "g1":
            out["sop"], out["fold_planned"] = 1, 1
        else:
            out["fold_planned"] = 2
    elif name == "clear_cofactor":
        if group == "g1":
            mul_by_const(params.H_EFF_G1)
        else:
            for _ in range(3):
                mul_by_const(x)
            plan("add", 5)
            plan("double", 1)
            out["fold_planned"] = 3
    elif name == "batch_normalize":
        out["sop"] = 4 * lg(n) + 2 + (group == "g2")
        out["pow_fixed"] = 1
        out["fold_planned"] = {"g1": 1, "g2": 2}[group]
    else:
        raise ValueError(f"no schedule for {group}.{name}")
    out["plan_exec"] = sum(plans.values())
    out["plan_exec_by_plan"] = plans
    return out


def normalize_inputs(group: str, n: int, device):
    """Projective P_i = [i+1]G over n lanes (a scan of the group law; z is
    not one), the lanes i % 64 == 5 the identity, as entry.msm_inputs makes
    them for a power of two."""
    import torch

    from bls12_381_torch import entry
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.utils import scans

    mod = {"g1": g1, "g2": g2}[group]
    pts = scans.inclusive_scan(mod.add, mod.generator((n,), device),
                               mod.identity((1,), device))
    lane = torch.arange(n, device=device) % entry.MSM_LANE_CYCLE
    return scans.tree_map(
        lambda i, p: torch.where(lane == entry.MSM_IDENTITY_LANE, i, p),
        mod.identity((n,), device), pts)


def with_bad_lanes(group: str, pts, device):
    """pts with the lanes i % 64 == BAD_LANE replaced by the host's point
    outside the subgroup (hostmath.g1/g2_point_outside_subgroup)."""
    import torch

    from bls12_381_torch import hostmath as hm
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.fields import fp, tower as tw
    from bls12_381_torch.utils import scans

    n = scans.tree_leaves(pts)[0].shape[-1]
    if group == "g1":
        x, y = hm.g1_point_outside_subgroup()
        bad = g1.from_affine((fp.const(x, (n,), device),
                              fp.const(y, (n,), device),
                              torch.zeros(n, dtype=torch.bool,
                                          device=device)))
    else:
        x, y = hm.g2_point_outside_subgroup()
        bad = g2.from_affine((tw.fp2_const(x, (n,), device),
                              tw.fp2_const(y, (n,), device),
                              torch.zeros(n, dtype=torch.bool,
                                          device=device)))
    mask = torch.arange(n, device=device) % 64 == BAD_LANE
    return scans.tree_map(lambda b, p: torch.where(mask, b, p), bad, pts)


def affine_to_host(group: str, aff):
    """Host affine ints (None for the identity) of an affine batch."""
    from bls12_381_torch.fields import fp, tower as tw

    x, y, inf = aff
    if group == "g1":
        xy = ((int(a), int(b)) for a, b in zip(fp.to_ints(x), fp.to_ints(y)))
    else:
        (x0, x1), (y0, y1) = tw.fp2_to_ints(x), tw.fp2_to_ints(y)
        xy = (((int(a), int(b)), (int(c), int(d)))
              for a, b, c, d in zip(x0, x1, y0, y1))
    return [None if i else v for v, i in zip(xy, inf.tolist())]


def pick_lanes(t, lanes):
    """A nested tuple of tensors at some lanes of its last axis."""
    import torch

    from bls12_381_torch.utils import scans

    idx = torch.tensor(lanes, device=scans.tree_leaves(t)[0].device)
    return scans.tree_map(lambda x: x.index_select(-1, idx), t)


def affine_lanes(group: str, pts, lanes):
    """Host affine ints of a projective batch at some lanes, through the
    port's to_affine on the device."""
    from bls12_381_torch.curves import g1, g2

    return affine_to_host(group, {"g1": g1, "g2": g2}[group].to_affine(
        pick_lanes(pts, lanes)))


def gt_lanes(f, lanes):
    """Host Fp12 values (nested int tuples) of a Gt batch at some lanes."""
    from bls12_381_torch.fields import tower as tw

    h = tw.fp12_to_host(f)
    return [tuple(tuple((int(c[0][i]), int(c[1][i])) for c in c6)
                  for c6 in h) for i in lanes]


def same_tree(a, b) -> bool:
    """Two nested tuples of tensors hold equal limbs (any devices)."""
    from bls12_381_torch.utils import scans

    return all(x.cpu().equal(y.cpu()) for x, y in
               zip(scans.tree_leaves(a), scans.tree_leaves(b)))


def expected_codec_launches(group: str, form: str, n: int) -> dict:
    """Kernel launches of one call of a codec function of curves/g1.py or
    g2.py (`form` is its name: from_compressed_host, from_uncompressed_host,
    to_compressed_host or to_uncompressed_host) over n lanes; no step
    depends on n.
      - a parse: to_mont of every coordinate it reads (one sop);
        from_compressed: x^2 x (G1 a sqr and a sop, G2 two folds), the
        square root (G1 one pow_fixed and a sqr for its check; G2
        tw.fp2_sqrt: two fp2_pow_fixed and five folds), the sign of y (one
        sop); from_uncompressed: is_on_curve (two folds, and b z^3: G1 a
        sop, G2 a fold); then the subgroup check, is_torsion_free (G1 two
        [|z|] chains, beta x (a sop) and eq's fold; G2 one chain, psi's
        fold and eq's fold);
      - to_compressed: from_mont of x (one sop) and the sign of y (one
        sop); to_uncompressed: from_mont of x and y (one sop)."""
    from bls12_381_torch import params

    out = zero_launches()
    plans = {}
    g1 = group == "g1"
    if form.startswith("to_"):
        out["sop"] = 2 if form == "to_compressed_host" else 1
    else:
        x = params.BLS_X
        chains = 2 if g1 else 1
        plans = {f"{group}_double_plan": chains * x.bit_length(),
                 f"{group}_add_plan": chains * bin(x).count("1")}
        out["sop"] = 1 + int(g1)
        out["fold_planned"] = 1 + int(not g1)
        if form == "from_compressed_host":
            out["sop"] += 1
            if g1:
                out["sqr"], out["pow_fixed"] = 2, 1
                out["sop"] += 1
            else:
                out["fold_planned"] += 2 + 5
                out["fp2_pow_fixed"] = 2
        else:
            out["fold_planned"] += 2 + int(not g1)
            out["sop"] += int(g1)
    out["plan_exec"] = sum(plans.values())
    out["plan_exec_by_plan"] = plans
    return out


def expected_h2c_launches(group: str, kind: str, n: int) -> dict:
    """Kernel launches of one call of hash_to_curve_* (kind "hash") or
    encode_to_curve_* (kind "encode") with device expansion over n >= 16
    lanes:
      - hash_to_field: the message expansion (one xmd_sha256), from_okm,
        one fold (lo R^2 and hi R^3);
      - the map, u0 and u1 as one batch for "hash": the SSWU map (G1: 7
        sqr, 16 sop and 4 pow_fixed for two inversions and two square
        roots; G2: 5 + 14 folds for its squares and products, two fp2_inv
        of a sop, a pow_fixed and a fold each, two fp2_sqrt of two
        fp2_pow_fixed and five folds each, two fp2_sgn0 of a sop each),
        then the isogeny: Horner over the four coefficient lists (one
        product per coefficient but the top one) and four products (G1 sop,
        G2 fold);
      - "hash": one add of the two halves;
      - clear_cofactor, as `expected_smul_launches` counts it."""
    from bls12_381_torch import params

    out = expected_smul_launches(group, "clear_cofactor", n)
    plans = dict(out["plan_exec_by_plan"])
    iso = {"g1": "iso11", "g2": "iso3"}[group]
    products = 4 + sum(len(params.ISO_CONSTS[f"{iso}_{part}"]) - 1
                       for part in ("xnum", "xden", "ynum", "yden"))
    out["fold_planned"] += 1
    out["xmd_sha256"] += 1
    if group == "g1":
        out["sqr"] += 7
        out["sop"] += 16 + products
        out["pow_fixed"] += 4
    else:
        out["fold_planned"] += 5 + 14 + 2 + 2 * 5 + products
        out["sop"] += 2 + 2
        out["pow_fixed"] += 2
        out["fp2_pow_fixed"] += 4
    if kind == "hash":
        plans[f"{group}_add_plan"] += 1
    out["plan_exec"] = sum(plans.values())
    out["plan_exec_by_plan"] = plans
    return out


def codec_host_points(group: str, n: int):
    """The host affine points of `entry.codec_inputs` at n lanes: [i+1]G,
    the identity (None) at the identity lanes, the host's point outside
    the subgroup at the lanes i % 64 == CODEC_BAD_LANE."""
    from bls12_381_torch import entry, hostmath as hm, params

    add = {"g1": hm.g1_add, "g2": hm.g2_add}[group]
    gen = {"g1": params.G1_GEN, "g2": params.G2_GEN}[group]
    bad = {"g1": hm.g1_point_outside_subgroup,
           "g2": hm.g2_point_outside_subgroup}[group]()
    out, acc = [], None
    for i in range(n):
        acc = add(acc, gen)
        lane = i % entry.MSM_LANE_CYCLE
        out.append(None if lane == entry.MSM_IDENTITY_LANE else
                   bad if lane == entry.CODEC_BAD_LANE else acc)
    return out


def reject_cases(group: str, form: str):
    """(label, encoding) pairs that a parse must mark invalid (verify skill
    "Probes"): flag bits wrong, an infinity with a nonzero x or the sort bit,
    an x >= p, an x off the curve (compressed) or a point off the curve
    (uncompressed); the host oracle raises on each."""
    from bls12_381_torch import hostmath as hm, params

    P = params.P
    enc = getattr(hm, f"{group}_to_{form}")
    gen = {"g1": params.G1_GEN, "g2": params.G2_GEN}[group]
    good = bytearray(enc(gen))
    width = 48 if group == "g1" else 96
    cases = []

    def case(label, data):
        cases.append((label, bytes(data)))

    flip = bytearray(good)
    flip[0] ^= 0b1000_0000
    case("compression bit wrong", flip)
    inf_x = bytearray(good)
    inf_x[0] |= 0b0100_0000
    case("infinity with a nonzero x", inf_x)
    inf_sort = bytearray(len(good))
    inf_sort[0] = (0b1110_0000 if form == "compressed" else 0b0110_0000)
    case("infinity with the sort bit", inf_sort)
    big = bytearray(good)
    big[:48] = P.to_bytes(48, "big")
    big[0] |= good[0] & 0b1110_0000
    case("x >= p", big)
    if form == "compressed":
        x = 1
        while (hm.fp_sqrt((x ** 3 + params.B_G1) % P) if group == "g1" else
               hm.fp2_sqrt(hm.fp2_add(hm.fp2_mul(hm.fp2_square((x, 0)),
                                                 (x, 0)), params.B_G2))) \
                is not None:
            x += 1
        off = bytearray(hm.fp_to_bytes(x) if group == "g1" else
                        hm.fp2_to_bytes((x, 0)))
        off[0] |= 0b1000_0000
        case("x off the curve", off)
    else:
        off = bytearray(good)
        off[-1] ^= 1
        case("point off the curve", off)
        sort = bytearray(good)
        sort[0] |= 0b0010_0000
        case("sort bit set", sort)
    assert all(len(c) == len(good) and len(good) in (width, 2 * width)
               for _, c in cases)
    return cases


def expected_bls_launches(n: int) -> dict:
    """Kernel launches of `bls_round_trip` over n >= 16 lanes, by
    kernel (the pairing's plans are not counted by name): keygen
    (g1.scalar_mul, to_affine), sign (hash_to_curve_g2 with its one
    xmd_sha256, g2.scalar_mul, to_affine), serialize (both compressed
    encoders), parse (both compressed decoders with the subgroup checks),
    verify (hash_to_curve_g2, to_affine, one pairing over 2n lanes)."""
    parts = [expected_smul_launches("g1", "scalar_mul", n),
             expected_smul_launches("g1", "batch_normalize", n),
             expected_h2c_launches("g2", "hash", n),
             expected_smul_launches("g2", "scalar_mul", n),
             expected_smul_launches("g2", "batch_normalize", n),
             expected_codec_launches("g1", "to_compressed_host", n),
             expected_codec_launches("g2", "to_compressed_host", n),
             expected_codec_launches("g1", "from_compressed_host", n),
             expected_codec_launches("g2", "from_compressed_host", n),
             expected_h2c_launches("g2", "hash", n),
             expected_smul_launches("g2", "batch_normalize", n),
             expected_launches()]
    return {k: sum(p[k] for p in parts) for k in parts[-1]}


def expected_oracle_launches(check: str, n: int) -> dict:
    """Kernel launches of one device call held to the host oracle over n
    lanes:
      - "h2c_<group>_<kind>": `expected_h2c_launches`;
      - "multi_pairing": the aggregate pairing with its final
        exponentiation on one rank (`expected_parallel_launches`);
      - "psi": one fold (c_x x^p and c_y y^p as one Fp2 product pair);
      - "fr_sqrt": the power a^((t-1)/2), then Fr products and squares
        (each a sop_fr launch): two products for x and a^t, per bit k of
        the 2^32-order discrete log 31 - k squares and a product (and for
        k > 0 one for the root's correction), the root's product, and the
        check's square: 2 + 496 + 32 + 31 + 1 + 1;
      - "fr_inv": one power; "fr_from_bytes" / "fr_to_bytes": one product
        (to or from Montgomery form); "fr_from_bytes_wide": none (the
        reduction runs on the host);
      - "fp_from_bytes": one product (to Montgomery form)."""
    if check.startswith("h2c_"):
        _, group, kind = check.split("_")
        return expected_h2c_launches(group, kind, n)
    if check == "multi_pairing":  # by kernel (its plans not by name)
        return expected_parallel_launches("pairing_agg_fe", n, (1,))
    zero = zero_launches()
    S = 32
    extra = {"psi": {"fold_planned": 1},
             "fr_sqrt": {"pow_fixed_fr": 1,
                         "sop_fr": 2 + S * (S - 1) // 2 + S + (S - 1) + 2},
             "fr_inv": {"pow_fixed_fr": 1},
             "fr_from_bytes": {"sop_fr": 1}, "fr_to_bytes": {"sop_fr": 1},
             "fr_from_bytes_wide": {}, "fp_from_bytes": {"sop": 1}}[check]
    return {**zero, **extra}


def host_multi_pairing(terms):
    """The host oracle's final_exponentiation(multi_miller_loop(terms))."""
    from bls12_381_torch import hostmath as hm

    return hm.final_exponentiation(hm.multi_miller_loop(terms))


def oracle_inputs() -> dict:
    """The host oracle checks' inputs from SEED: the G2 hash lanes (0 and
    the last among them), the multi-pairing's host terms ([a]G1, [b]G2 with
    a G1 and a G2 identity), the Fr values (0, 1, q - 1, 4 and the non-square 7
    first), the Fr byte rows ending in the non-canonical q, q + 1,
    2^256 - 1, the 64-byte wide rows, the 48-byte Fp rows of the native
    codec (p, p + 1 and 2^381 - 1 first, about a fifth of the rest >= p)
    and a 300-byte DST."""
    import random

    import numpy as np

    from bls12_381_torch import hostmath as hm, params

    P, Q = params.P, params.Q
    rnd = random.Random(SEED)
    n = 1 << H2C_LOG_N
    g2_lanes = sorted({0, n - 1} | set(rnd.sample(range(1, n - 1),
                                                  ORACLE_G2_LANES - 2)))
    terms = [(hm.g1_mul(params.G1_GEN, rnd.randrange(1, Q)),
              hm.g2_mul(params.G2_GEN, rnd.randrange(1, Q)))
             for _ in range(ORACLE_TERMS)]
    terms[1] = (None, terms[1][1])
    terms[4] = (terms[4][0], None)
    n_fr = 1 << ORACLE_FR_LOG_N
    fr_vals = [0, 1, Q - 1, 4, 7] + [rnd.randrange(Q)
                                     for _ in range(n_fr - 5)]
    fr_rows = [v.to_bytes(32, "little") for v in fr_vals[:-3]] + [
        v.to_bytes(32, "little") for v in (Q, Q + 1, (1 << 256) - 1)]
    wide = [bytes(64), b"\xff" * 64, Q.to_bytes(64, "little")] + [
        rnd.randbytes(64) for _ in range(n_fr - 3)]
    n_fp = 1 << ORACLE_CODEC_LOG_N
    fp_vals = [P, P + 1, (1 << 381) - 1, 0, 1, P - 1] + [
        rnd.randrange(P + P // 4) for _ in range(n_fp - 6)]
    fp_rows = np.frombuffer(b"".join(v.to_bytes(48, "big") for v in fp_vals),
                            np.uint8).reshape(n_fp, 48)
    return {"g2_lanes": g2_lanes, "terms": terms, "fr_vals": fr_vals,
            "fr_rows": fr_rows, "wide": wide, "fp_vals": fp_vals,
            "fp_rows": fp_rows, "big_dst": rnd.randbytes(300)}


def expected_parallel_launches(kind: str, n: int, mesh_shape: tuple,
                                window: int = PARALLEL_WINDOW,
                                fold: bool = False) -> dict:
    """Kernel launches of one call of a sharded path on one rank of a mesh
    of `mesh_shape`, from the schedules of parallel/ (n: the global batch,
    points or transform size):
      - pairing: the pairing's schedule on the rank's shard
        (`expected_launches`; the same at any batch);
      - pairing_agg (final_exp=False): prepare_g2 and the Miller loop (68
        plans each, the line scaling's fold), the halving tree product of
        the shard (ceil(lg b) fp12_mul) and of each axis' gathered values
        (ceil(lg size)); pairing_agg_fe adds one final exponentiation;
      - msm_g1 / msm_g2: the local msm of the shard
        (`expected_msm_launches`, on a card fold=True) and size - 1 adds
        per axis;
      - ntt / intt: two local NTTs of lengths n1 and n2 (lg N butterflies,
        lg n1 - 1 + lg n2 - 1 twiddle doublings) and the outer twiddle
        product, the inverse's 1/N scaling: `expected_ntt_launches`'s
        counts, with the twiddle table cached (its first call adds 2 lg n2
        `sop_fr` launches).
    `copied_rows` is 0 on every path."""
    import importlib

    def lg(m):
        return (m - 1).bit_length()

    ranks = math.prod(mesh_shape)
    if kind in ("ntt", "intt"):
        return expected_ntt_launches(n, kind == "intt")
    if kind in ("msm_g1", "msm_g2"):
        group = kind[-2:]
        want = expected_msm_launches(group, n // ranks, window, fold=fold)
        adds = sum(size - 1 for size in mesh_shape)
        want["plan_exec"] += adds
        want["plan_exec_by_plan"][f"{group}_add_plan"] += adds
        return want
    pm = importlib.import_module("bls12_381_torch.pairing.pairing")
    whole = expected_launches()
    if kind == "pairing":
        return whole
    tree = lg(n // ranks) + sum(lg(size) for size in mesh_shape)
    want = {**zero_launches(), "plan_exec": 2 * pm.N_COEFFS + tree,
            "fold_planned": 1}
    del want["plan_exec_by_plan"]
    if kind == "pairing_agg_fe":  # the pairing's schedule less its Miller part
        want["plan_exec"] += whole["plan_exec"] - 2 * pm.N_COEFFS
        want["fold_planned"] += whole["fold_planned"] - 1
        want["sop"], want["pow_fixed"] = whole["sop"], whole["pow_fixed"]
    return want


def parallel_kind(row: str) -> str:
    """The schedule of a `parallel_rows` row: its name up to the size or
    mesh suffix ("ntt_20_2x2" -> "ntt")."""
    return next(k for k in PARALLEL_KINDS
                if row == k or row.startswith(k + "_"))


def digest(tree) -> str:
    """SHA-256 of a nested tuple of tensors (shapes, dtypes and limbs):
    equal digests are equal values."""
    import hashlib

    from bls12_381_torch.utils import scans

    h = hashlib.sha256()
    for t in scans.tree_leaves(tree):
        t = t.detach().cpu().contiguous()
        h.update(f"{tuple(t.shape)} {t.dtype}".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def affine_of(mod):
    """A projective point with an empty batch shape -> its affine (x, y,
    inf) over one lane, through the port's to_affine."""
    from bls12_381_torch.utils import scans

    return lambda pt: mod.to_affine(scans.tree_map(
        lambda t: t.unsqueeze(-1), pt))


def as_is(value):
    return value


def parallel_rows(inputs: dict, window: int, world: int):
    """(row, call, post) of the sharded paths over the initialised world:
    every sharded path on the 1-D mesh of all ranks, and for a world of
    PARALLEL_RANKS msm_g1 and the NTTs on the 2 x world/2 mesh as well.
    `post` turns a call's value into what is compared (affine points for
    the MSMs).  inputs: "pairing" (p_aff, q_aff), "msm_g1" / "msm_g2"
    (points, scalars), "ntt" {lg N: coefficients}, "ntt_y" {lg N: their
    transform}, the same on every rank."""
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.parallel import (mesh as mesh_mod, msm_g1_sharded,
                                          msm_g2_sharded, ntt_sharded,
                                          pairing_sharded)

    mesh = mesh_mod.make_mesh()
    meshes = [("", mesh)]
    if world == PARALLEL_RANKS:
        meshes.append((f"_2x{world // 2}", mesh_mod.make_mesh_2d(
            2, world // 2)))
    p, q = inputs["pairing"]
    rows = [
        ("pairing", lambda: pairing_sharded(mesh, p, q), as_is),
        ("pairing_agg", lambda: pairing_sharded(
            mesh, p, q, aggregate=True, final_exp=False), as_is),
        ("pairing_agg_fe", lambda: pairing_sharded(
            mesh, p, q, aggregate=True), as_is),
        ("msm_g2", lambda: msm_g2_sharded(mesh, *inputs["msm_g2"], c=window),
         affine_of(g2))]
    for suffix, m in meshes:
        rows.append((f"msm_g1{suffix}", lambda m=m: msm_g1_sharded(
            m, *inputs["msm_g1"], c=window), affine_of(g1)))
        for log_n, x in inputs["ntt"].items():
            y = inputs["ntt_y"][log_n]
            rows += [(f"ntt_{log_n}{suffix}",
                      lambda m=m, x=x: ntt_sharded(m, x), as_is),
                     (f"intt_{log_n}{suffix}",
                      lambda m=m, y=y: ntt_sharded(m, y, inverse=True),
                      as_is)]
    return rows


def parallel_local(inputs: dict, window: int) -> dict:
    """row -> (call, post) of the local (one-device) path that each row of
    `parallel_rows` must equal; the 2-D rows share the 1-D rows'."""
    from bls12_381_torch import pairing as pr
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.ops import msm, ntt

    p, q = inputs["pairing"]
    local = {
        "pairing": (lambda: pr.pairing(p, q), as_is),
        "pairing_agg": (lambda: pr.multi_miller_loop(p, pr.prepare_g2(q)),
                        as_is),
        "pairing_agg_fe": (lambda: pr.final_exponentiation(
            pr.multi_miller_loop(p, pr.prepare_g2(q))), as_is),
        "msm_g1": (lambda: msm.msm_g1(*inputs["msm_g1"], c=window),
                   affine_of(g1)),
        "msm_g2": (lambda: msm.msm_g2(*inputs["msm_g2"], c=window),
                   affine_of(g2))}
    for log_n, x in inputs["ntt"].items():
        y = inputs["ntt_y"][log_n]
        local[f"ntt_{log_n}"] = (lambda x=x: ntt.ntt(x), as_is)
        local[f"intt_{log_n}"] = (lambda y=y: ntt.intt(y), as_is)
    return local


def parallel_job(spec: dict, inputs_path: str) -> dict:
    """One rank's run of the sharded paths (on the CPU in
    tests/test_torch_parallel.py, on cuda:0 in
    tests/test_torch_kernels_gpu.py), in an initialised process group: the
    inputs from `inputs_path` on spec["device"], then per row of
    `parallel_rows` an uncounted warm-up call when spec["reps"] timed calls
    follow (it builds the NTT's twiddle table), a call with the launch
    counts set to 0 just before it and read just after (with the row's own
    peak memory on a card), and the spec["reps"] timed calls, each started
    together on every rank (a barrier) and ended in a synchronize; then
    `multichip_entry` once.  Returns row -> {"value": the compared value (its
    `digest` unless spec["values"]), "launches", "first_seconds",
    "seconds", "cpu_seconds", "peak_bytes", "held_bytes"}, "entry" ->
    the entry's (results, inputs) on the CPU, and in a world of
    PARALLEL_RANKS "shards" -> {`shard_label(a)`: the lanes of a batch of
    2 PARALLEL_RANKS that `shard_batch` gives this rank on the 2-D mesh
    with axis_name a, for a in SHARD_AXES}."""
    import torch
    import torch.distributed as dist

    from bls12_381_torch import entry
    from bls12_381_torch.kernels import LAUNCHES
    from bls12_381_torch.parallel import mesh as mesh_mod

    device = torch.device(spec["device"])
    cuda = device.type == "cuda"
    inputs = torch.load(inputs_path, map_location=device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    out = {}
    for row, call, post in parallel_rows(inputs, spec["window"],
                                         dist.get_world_size()):
        if spec["reps"]:
            call()
            sync()
        dist.barrier()
        held = peak = None
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
            held = torch.cuda.memory_allocated(device)
        LAUNCHES.reset()
        t0 = time.perf_counter()
        value = call()
        sync()
        first = time.perf_counter() - t0
        counts = LAUNCHES.snapshot()
        if cuda:
            peak = torch.cuda.max_memory_allocated(device) - held
        wall, cpu = [], []
        for _ in range(spec["reps"]):
            dist.barrier()
            t0, c0 = time.perf_counter(), time.thread_time()
            call()
            cpu.append(time.thread_time() - c0)
            sync()
            wall.append(time.perf_counter() - t0)
        value = post(value)
        out[row] = {"value": to_cpu(value) if spec["values"]
                    else digest(value), "launches": counts,
                    "first_seconds": first, "seconds": wall,
                    "cpu_seconds": cpu, "peak_bytes": peak,
                    "held_bytes": held}
    results, ins = entry.multichip_entry(dist.get_world_size(), device)
    out["entry"] = to_cpu((results, ins))
    if dist.get_world_size() == PARALLEL_RANKS:
        mesh2 = mesh_mod.make_mesh_2d(2, PARALLEL_RANKS // 2)
        lanes = torch.arange(2 * PARALLEL_RANKS, device=device)
        out["shards"] = {shard_label(a): mesh_mod.shard_batch(
            mesh2, lanes, axis_name=a).tolist() for a in SHARD_AXES}
    return out


def shard_label(axis_name) -> str:
    """"all" for axis_name None, else the axis names joined by commas."""
    if axis_name is None:
        return "all"
    return axis_name if isinstance(axis_name, str) else ",".join(axis_name)


def expected_shards(rank: int, world: int) -> dict:
    """The lanes of a batch of 2 world that rank holds on the 2 x world/2
    mesh (ranks host-major) for each axis_name of SHARD_AXES: the batch in
    as many blocks as the named axes have ranks, block index the rank's
    coordinates along them, the first axis major (the JAX package's
    NamedSharding)."""
    coord = dict(zip(("host", "x"), divmod(rank, world // 2)))
    size = {"host": 2, "x": world // 2}
    out = {}
    for a in SHARD_AXES:
        names = ("host", "x") if a is None else (a,) if isinstance(a, str) \
            else a
        n_blocks = math.prod(size[k] for k in names)
        index = 0
        for k in names:
            index = index * size[k] + coord[k]
        b = 2 * world // n_blocks
        out[shard_label(a)] = list(range(index * b, index * b + b))
    return out


def parallel_rank(rank: int, world: int, backend: str, store: str,
                  spec: dict, inputs_path: str, out_dir: str) -> None:
    """A spawned rank: set its device and one host thread, join the
    process group (a file store), run `parallel_job`, save what it
    returns to out_dir/rank{rank}.pt and leave the group."""
    import torch
    import torch.distributed as dist

    if torch.device(spec["device"]).type == "cuda":
        torch.cuda.set_device(torch.device(spec["device"]))
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    out = parallel_job(spec, inputs_path)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def spawn_ranks(world: int, backend: str, spec: dict, inputs_path: str,
                tmp: str) -> list:
    """`parallel_job` on `world` spawned ranks (start method spawn: CUDA
    cannot be forked; the kernels must be built already); raises if a rank
    raises or exits nonzero (the others are then ended).  Returns each
    rank's value, in rank order."""
    import torch
    import torch.multiprocessing as mp

    store = str(Path(tmp) / f"store_{backend}_{world}")
    mp.start_processes(parallel_rank, args=(
        world, backend, store, spec, inputs_path, tmp), nprocs=world,
        join=True, start_method="spawn")
    return [torch.load(Path(tmp) / f"rank{r}.pt")
            for r in range(world)]


def to_cpu(obj):
    """Tensors of nested dicts, tuples and lists copied to the CPU."""
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_cpu(v) for v in obj)
    return obj.cpu()


def fp12_host(f) -> tuple:
    """An Fp12 value with an empty batch shape as host nested int tuples."""
    from bls12_381_torch.fields import tower as tw

    return tuple(tuple((int(c[0]), int(c[1])) for c in c6)
                 for c6 in tw.fp12_to_host(f))


def msm_host(group: str, pts, sc):
    """The host's [sum_i k_i (i+1) mod q]G of `entry.msm_inputs`' points
    (P_i = [i+1]G, identity lanes skipped) and Montgomery scalars, through
    `msm_host_sum`."""
    from bls12_381_torch import hostmath as hm, params
    from bls12_381_torch.curves import g1, g2

    skip = {"g1": g1, "g2": g2}[group].is_identity(pts).cpu().numpy()
    return {"g1": hm.g1_mul, "g2": hm.g2_mul}[group](
        {"g1": params.G1_GEN, "g2": params.G2_GEN}[group],
        msm_host_sum(sc, skip))


def bls_round_trip(n: int, device, seed: int = SEED):
    """The BLS signature round trip over n lanes through the port's public
    functions (the proof-of-possession suite, BLS_DST; minimal public keys
    in G1, signatures in G2; 32-byte messages from the seed): keygen
    ([sk]G1, `g1.scalar_mul`), sign (`hash_to_curve_g2`, then
    `g2.scalar_mul`), serialize (48- and 96-byte compressed), parse with
    the subgroup checks, verify e(pk, H(m)) == e(G1, sig) through `pairing`
    and `fp12_eq`.  The lanes i % 64 == BLS_WRONG_MESSAGE sign another
    message, BLS_FLIPPED_BIT flip one body bit of the signature on the
    wire, BLS_OUTSIDE_G2 send a point outside G2 as the signature.  Returns
    numpy bool [n] arrays: (verified, key parsed, signature parsed)."""
    import numpy as np
    import torch

    from bls12_381_torch import hostmath as hm, limbs, params
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.fields import tower as tw
    from bls12_381_torch.hash_to_curve import h2c
    from bls12_381_torch.pairing import pairing
    from bls12_381_torch.utils import scans

    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    sks = [int.from_bytes(rng.bytes(32), "little") % (params.Q - 1) + 1
           for _ in range(n)]
    lane = np.arange(n) % 64
    signed = msgs.copy()
    signed[lane == BLS_WRONG_MESSAGE, 0] ^= 0xFF  # another message
    sk = limbs.from_ints(limbs.FR, sks, device=device)

    pk = g1.to_affine(g1.scalar_mul(g1.generator((n,), device), sk))
    h_signed = h2c.hash_to_curve_g2(signed, BLS_DST, expand="device",
                                    device=device)
    sig = g2.to_affine(g2.scalar_mul(h_signed, sk))
    pk_bytes = g1.to_compressed_host(pk)
    sig_bytes = g2.to_compressed_host(sig)
    # the tampered lanes, in the bytes on the wire
    sig_bytes[lane == BLS_FLIPPED_BIT, 60] ^= 0x10
    sig_bytes[lane == BLS_OUTSIDE_G2] = np.frombuffer(
        hm.g2_to_compressed(hm.g2_point_outside_subgroup()), np.uint8)
    pk_aff, pk_ok = g1.from_compressed_host(pk_bytes, device=device)
    sig_aff, sig_ok = g2.from_compressed_host(sig_bytes, device=device)
    h_msg = g2.to_affine(h2c.hash_to_curve_g2(msgs, BLS_DST, expand="device",
                                              device=device))
    parsed = torch.from_numpy(pk_ok & sig_ok).to(device)
    pk_aff = pk_aff[:2] + (pk_aff[2] | ~parsed,)
    sig_aff = sig_aff[:2] + (sig_aff[2] | ~parsed,)
    ps = scans.tree_map(lambda a, b: torch.cat([a, b], -1), pk_aff,
                        g1.generator_affine((n,), device))
    qs = scans.tree_map(lambda a, b: torch.cat([a, b], -1), h_msg, sig_aff)
    f = pairing(ps, qs)
    equal = tw.fp12_eq(scans.tree_map(lambda t: t[..., :n], f),
                       scans.tree_map(lambda t: t[..., n:], f))
    return (parsed & equal).cpu().numpy(), pk_ok, sig_ok


def round_trip_faults(verified, pk_ok, sig_ok) -> list:
    """What a `bls_round_trip` got wrong, as messages: every honest lane
    verifies and no tampered lane does; a signature of another message
    parses (the pairing refuses it); a point outside G2 does not parse."""
    import numpy as np

    lane = np.arange(len(verified)) % 64
    honest = ~np.isin(lane, (BLS_WRONG_MESSAGE, BLS_FLIPPED_BIT,
                             BLS_OUTSIDE_G2))
    faults = []
    if not verified[honest].all():
        faults.append(f"honest lanes {np.flatnonzero(honest & ~verified)} "
                      "do not verify")
    if verified[~honest].any():
        faults.append(f"tampered lanes {np.flatnonzero(~honest & verified)} "
                      "verify")
    if not (pk_ok & sig_ok)[lane == BLS_WRONG_MESSAGE].all():
        faults.append("a signature of another message does not parse")
    if sig_ok[lane == BLS_OUTSIDE_G2].any():
        faults.append("a signature outside G2 parses")
    return faults
