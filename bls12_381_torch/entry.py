"""Entry points of the port's paths: the batched optimal-ate pairing, the
radix-2 NTT over Fr, the G1/G2 multi-scalar multiplication, the batched
scalar multiplication of G1, G2 and Gt, the G1/G2 point decoders and
hash to curve.

`entry()` mirrors `__graft_entry__.entry()` of the JAX package: it returns
the pairing function and example inputs e([i+1]G1, [2i+1]G2), i < batch, on
the device (the card unless the caller asks for the CPU).  `ntt_entry()`
returns the NTT and random coefficients at N = 2^log_n, as `bench.py`'s
`bench_ntt` times it.  `msm_entry()` returns `msm_g1_large` (which is
`msm_g1` up to 2^21 points) or `msm_g2` and N = 2^log_n points [i+1]G with
random scalars.  `smul_entry()` returns
`g1.scalar_mul`, `g2.scalar_mul` or `gt.scalar_mul` and N = 2^log_n bases
with one random scalar each, as `bench.py`'s `bench_curves` times them.
`codec_entry()` returns `from_compressed_host` or `from_uncompressed_host`
of G1 or G2 and the encodings of `msm_inputs`' points, a point outside the
subgroup in every 64th lane, as `bench.py`'s `bench_deserialize` rows at
2^10.  `h2c_entry()` returns `hash_to_curve_*` or `encode_to_curve_*` with
device expansion and 256 random 32-byte messages under one DST, as
`bench.py`'s `bench_h2c` times them.  `multichip_entry()` mirrors
`__graft_entry__.dryrun_multichip()`: one step of each sharded path of
`parallel/` on a mesh of the initialised process group's ranks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import hostmath as hm
from . import params
from .curves import g1 as G1
from .curves import g2 as G2
from .fields import fp, fr, tower as tw
from .hash_to_curve import h2c
from .limbs import DTYPE, FR, resolve_device
from .ops import msm, ntt
from .pairing import gt, pairing
from .parallel import mesh as mesh_mod
from .parallel import msm_g1_sharded, ntt_sharded, pairing_sharded
from .utils import scans

# lanes i of msm_inputs with i % MSM_LANE_CYCLE == MSM_IDENTITY_LANE hold the
# identity point, those with i % MSM_LANE_CYCLE == MSM_ZERO_LANE the scalar 0;
# codec_inputs puts a point outside the subgroup at the lanes with
# i % MSM_LANE_CYCLE == CODEC_BAD_LANE
MSM_LANE_CYCLE, MSM_IDENTITY_LANE, MSM_ZERO_LANE = 64, 5, 9
CODEC_BAD_LANE = 17
H2C_DST = b"BENCH-DST_"


def tiny_pairing_inputs(batch: int, device="cuda"):
    """Affine batches P_i = [i+1]G1, Q_i = [2i+1]G2 on a device."""
    dev = resolve_device(device)
    phs = [hm.g1_mul(params.G1_GEN, i + 1) for i in range(batch)]
    qhs = [hm.g2_mul(params.G2_GEN, 2 * i + 1) for i in range(batch)]
    no_inf = torch.zeros((batch,), dtype=torch.bool, device=dev)
    p_aff = (fp.from_ints([p[0] for p in phs], device=dev),
             fp.from_ints([p[1] for p in phs], device=dev), no_inf)
    q_aff = (tw.fp2_from_ints([q[0] for q in qhs], device=dev),
             tw.fp2_from_ints([q[1] for q in qhs], device=dev), no_inf)
    return p_aff, q_aff


def entry(batch: int = 2, device="cuda"):
    """(fn, example_args): the batched pairing e(P_i, Q_i) and inputs."""
    return pairing, tiny_pairing_inputs(batch, device)


def ntt_inputs(log_n: int, batch=(), seed: int = 4, device="cuda"):
    """Random canonical Fr coefficients [16, *batch, 2^log_n], made on the
    device from a seeded `torch.Generator`: uniform 16-bit limbs with the
    top limb masked to 14 bits, so every value is < 2^254 < q (the
    distribution of `bench.py`'s `_rand_fr`).  Read as Montgomery limbs."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, 1 << 16, (FR.n_limbs,) + tuple(batch) + (1 << log_n,),
                      generator=gen, device=dev, dtype=DTYPE)
    x[-1] &= 0x3FFF
    return x


def ntt_entry(log_n: int = 20, seed: int = 4, device="cuda"):
    """(fn, example_args): the forward NTT and one batch of coefficients."""
    return ntt.ntt, (ntt_inputs(log_n, seed=seed, device=device),)


def _spot_check(group: str, pts, lanes, device) -> None:
    """Raise unless the affine values of `pts` at `lanes` are [i+1]G."""
    mod = {"g1": G1, "g2": G2}[group]
    idx = torch.tensor(lanes, device=device)
    ax, ay, _ = mod.to_affine(scans.tree_map(
        lambda t: t.index_select(-1, idx), pts))
    if group == "g1":
        got = [(int(x), int(y)) for x, y in zip(fp.to_ints(ax),
                                                fp.to_ints(ay))]
        want = [hm.g1_mul(params.G1_GEN, i + 1) for i in lanes]
    else:
        (x0, x1), (y0, y1) = tw.fp2_to_ints(ax), tw.fp2_to_ints(ay)
        got = [((int(a), int(b)), (int(c), int(d)))
               for a, b, c, d in zip(x0, x1, y0, y1)]
        want = [hm.g2_mul(params.G2_GEN, i + 1) for i in lanes]
    if got != want:
        raise RuntimeError(f"msm_inputs: {group} lanes {lanes} are not "
                           "[i+1]G")


def msm_inputs(log_n: int, group: str = "g1", seed: int = 5, device="cuda"):
    """(points, scalars) for an MSM over N = 2^log_n terms, on a device.

    Points: projective P_i = [i+1]G of the group ("g1" or "g2"), made on the
    device by an inclusive scan of the group law over copies of the
    generator and spot-checked at lanes 0, 1 and N-1 against hostmath; the
    lanes with i % MSM_LANE_CYCLE == MSM_IDENTITY_LANE hold the identity.
    Scalars: `ntt_inputs`' random Montgomery Fr [16, N] from `seed`, 0 at the
    lanes with i % MSM_LANE_CYCLE == MSM_ZERO_LANE."""
    mod = {"g1": G1, "g2": G2}[group]
    dev = resolve_device(device)
    n = 1 << log_n
    pts = scans.inclusive_scan(mod.add, mod.generator((n,), dev),
                               mod.identity((1,), dev))
    _spot_check(group, pts, sorted({0, 1 % n, n - 1}), dev)
    lane = torch.arange(n, device=dev) % MSM_LANE_CYCLE
    pts = scans.tree_map(
        lambda i, p: torch.where(lane == MSM_IDENTITY_LANE, i, p),
        mod.identity((n,), dev), pts)
    return pts, _scalars(log_n, seed, dev)


def _scalars(log_n: int, seed: int, device):
    """`ntt_inputs`' random Montgomery Fr [16, 2^log_n] from `seed`, 0 at the
    lanes i with i % MSM_LANE_CYCLE == MSM_ZERO_LANE."""
    lane = torch.arange(1 << log_n, device=device) % MSM_LANE_CYCLE
    return ntt_inputs(log_n, seed=seed, device=device).masked_fill(
        lane == MSM_ZERO_LANE, 0)


def msm_entry(log_n: int = 16, group: str = "g1", seed: int = 5,
              device="cuda"):
    """(fn, example_args): `msm.msm_g1_large` or `msm.msm_g2` (window
    `msm.MSM_WINDOW`, GLV/GLS split) and `msm_inputs`.  G1 takes
    `msm_g1_large`, as `bench.py` times every G1 row: up to 2^21 points
    (its default chunk) it is `msm_g1` itself, above that `msm_g1` over
    chunks of 2^21 points folded with single group additions."""
    fn = {"g1": msm.msm_g1_large, "g2": msm.msm_g2}[group]
    return fn, msm_inputs(log_n, group, seed, device)


def smul_inputs(log_n: int, group: str = "g1", seed: int = 5,
                device="cuda"):
    """(bases, scalars) for N = 2^log_n scalar multiplications on a device:
    for "g1" and "g2" `msm_inputs` (P_i = [i+1]G, identity and zero-scalar
    lanes), for "gt" the generator e(G1, G2) broadcast over the lanes with
    the same scalars."""
    if group != "gt":
        return msm_inputs(log_n, group, seed, device)
    dev = resolve_device(device)
    return gt.generator((1 << log_n,), dev), _scalars(log_n, seed, dev)


def smul_entry(log_n: int = 10, group: str = "g1", seed: int = 5,
               device="cuda"):
    """(fn, example_args): `g1.scalar_mul` (GLV), `g2.scalar_mul` (GLS) or
    `gt.scalar_mul` (GLS), each [k_i] B_i per lane, and `smul_inputs`."""
    fn = {"g1": G1.scalar_mul, "g2": G2.scalar_mul, "gt": gt.scalar_mul}[group]
    return fn, smul_inputs(log_n, group, seed, device)


def codec_inputs(log_n: int = 10, group: str = "g1",
                 form: str = "compressed", device="cuda") -> np.ndarray:
    """Encodings uint8 [2^log_n, n] of the affine [i+1]G of `msm_inputs`
    (the identity at its identity lanes) with the lanes
    i % MSM_LANE_CYCLE == CODEC_BAD_LANE replaced by
    `hostmath.g{1,2}_point_outside_subgroup()`, through the port's own
    encoder (`to_compressed_host` or `to_uncompressed_host`)."""
    mod = {"g1": G1, "g2": G2}[group]
    n = 1 << log_n
    dev = resolve_device(device)
    x, y, inf = mod.to_affine(msm_inputs(log_n, group, device=dev)[0])
    bad = torch.arange(n, device=dev) % MSM_LANE_CYCLE == CODEC_BAD_LANE
    if group == "g1":
        bx, by = (fp.const(c, (n,), device=dev)
                  for c in hm.g1_point_outside_subgroup())
    else:
        bx, by = (tw.fp2_const(c, (n,), dev)
                  for c in hm.g2_point_outside_subgroup())
    x, y = scans.tree_map(lambda b, p: torch.where(bad, b, p), (bx, by),
                          (x, y))
    return getattr(mod, f"to_{form}_host")((x, y, inf & ~bad))


def codec_entry(log_n: int = 10, group: str = "g1",
                form: str = "compressed", device="cuda"):
    """(fn, example_args): `from_compressed_host` (subgroup check on) or
    `from_uncompressed_host` (check on) of G1 or G2, decoding onto
    `device`, and `codec_inputs`."""
    mod = {"g1": G1, "g2": G2}[group]
    fn = functools.partial(getattr(mod, f"from_{form}_host"),
                           device=resolve_device(device))
    return fn, (codec_inputs(log_n, group, form, device),)


def h2c_inputs(log_n: int = 8) -> np.ndarray:
    """2^log_n random 32-byte messages, uint8 [2^log_n, 32], from
    `np.random.RandomState(5)` (`bench.py`'s `bench_h2c` at 256)."""
    return np.random.RandomState(5).randint(
        0, 256, size=(1 << log_n, 32)).astype(np.uint8)


def h2c_entry(log_n: int = 8, group: str = "g1", kind: str = "hash",
              device="cuda"):
    """(fn, example_args): `hash_to_curve_g1/_g2` (kind "hash") or
    `encode_to_curve_g1/_g2` (kind "encode") with device expansion onto
    `device`, and (`h2c_inputs`, H2C_DST)."""
    fn = functools.partial(getattr(h2c, f"{kind}_to_curve_{group}"),
                           expand="device", device=resolve_device(device))
    return fn, (h2c_inputs(log_n), H2C_DST)


def multichip_entry(n_devices: int, device="cuda"):
    """One step of each sharded path on a mesh of the n_devices ranks of
    the initialised process group (called on every rank; the counterpart
    of `__graft_entry__.dryrun_multichip`): `msm_g1_sharded` (window 4) of
    4 n points [1]G with random scalars on the 1-D mesh and, for even n, on
    the 2 x n/2 mesh; `ntt_sharded` at max(64, 4 n^2) random coefficients;
    the aggregate `pairing_sharded` of `tiny_pairing_inputs(n)` without the
    final exponentiation.  "cuda" is the rank's card
    (`parallel.mesh.rank_device`).  Returns (results, inputs), dicts keyed
    "msm", "msm_2d" (even n), "ntt", "pairing"; the inputs are the same on
    every rank."""
    mesh = mesh_mod.make_mesh(n_devices)
    dev = mesh_mod.rank_device(device)
    b = 4 * n_devices
    rng = np.random.RandomState(0)
    scalars = fr.from_ints(list(rng.randint(1, 1 << 30, size=b)),
                           device=dev)
    pts = G1.generator((b,), dev)
    results = {"msm": msm_g1_sharded(mesh, pts, scalars, c=4)}
    if n_devices % 2 == 0:
        results["msm_2d"] = msm_g1_sharded(
            mesh_mod.make_mesh_2d(2, n_devices // 2), pts, scalars, c=4)
    n = max(64, 4 * n_devices * n_devices)
    coeffs = fr.from_ints(list(rng.randint(0, 1 << 30, size=n)), device=dev)
    results["ntt"] = ntt_sharded(mesh, coeffs)
    p_aff, q_aff = tiny_pairing_inputs(n_devices, dev)
    results["pairing"] = pairing_sharded(mesh, p_aff, q_aff, aggregate=True,
                                         final_exp=False)
    inputs = {"msm": (pts, scalars), "ntt": coeffs,
              "pairing": (p_aff, q_aff)}
    return results, inputs
