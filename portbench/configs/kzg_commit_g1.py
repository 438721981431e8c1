"""Driver of `kzg_commit_g1`: a prover's G1 commitment, its SRS resident.

Inputs, made in set-up: the points P_i = [i+1]G1 on the card, projective,
by an inclusive scan of the program's group law over copies of the
generator (the recipe of `bls12_381_torch.entry.msm_inputs`), the identity
at the lanes i % lane_cycle == identity_lane; and `scalar_sets` distinct
scalar vectors drawn on the card from the seed as Montgomery limbs x
uniform below 2^254 (the scalar x R^-1 mod q), 0 at the lanes
i % lane_cycle == zero_scalar_lane.  Call i commits to scalar set
i % scalar_sets through `msm.msm_g1_large` with the library's defaults
(a test may pass a narrower window, `window_bits`) and brings the projective point
to the host.  The check holds every call's point to
`reference.commitment.expected`.
"""

from __future__ import annotations

import numpy as np
import torch

import devtrace
from reference import commitment

FR_LIMBS = 16
TOP_LIMB_MASK = 0x3FFF  # x < 2^254 < q


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 control: bool = False, window_bits: int | None = None):
        self.n = int(traffic["points_per_call"])
        self.sets = int(traffic["scalar_sets"])
        self.window_bits = window_bits
        self.cycle = int(config["lane_cycle"])
        self.identity_lane = int(config["identity_lane"])
        self.zero_lane = int(config["zero_scalar_lane"])
        self.seed, self.control = seed, control
        self.device = torch.device(device)
        self.distinct_inputs = self.sets
        self.spans = devtrace.Spans()

    def lanes(self):
        return torch.arange(self.n, device=self.device) % self.cycle

    def setup(self) -> None:
        from bls12_381_torch.curves import g1
        from bls12_381_torch.ops import msm
        from bls12_381_torch.utils import scans

        dev, n = self.device, self.n
        self.entry = msm.msm_g1_large
        lane = self.lanes()
        pts = scans.inclusive_scan(g1.add, g1.generator((n,), dev),
                                   g1.identity((1,), dev))
        self.points = scans.tree_map(
            lambda i, p: torch.where(lane == self.identity_lane, i, p),
            g1.identity((n,), dev), pts)
        self.scalars = self.make_scalars()
        if self.control:
            self.scalars = [cut_scalars(x) for x in self.scalars]

    def call(self, i: int):
        kw = {} if self.window_bits is None else {"c": self.window_bits}
        with self.spans.span("msm_g1_large"):
            point = self.entry(self.points, self.scalars[i % self.sets], **kw)
        with self.spans.span("to_host"):
            return torch.stack(point).cpu().numpy(), self.n

    def make_scalars(self) -> list:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed % (1 << 64))
        lane = self.lanes()
        sets = []
        for _ in range(self.sets):
            x = torch.randint(0, 1 << 16, (FR_LIMBS, self.n), generator=gen,
                              device=self.device, dtype=torch.int32)
            x[-1] &= TOP_LIMB_MASK
            sets.append(x.masked_fill(lane == self.zero_lane, 0))
        return sets

    def reference_inputs(self):
        """The scalar limbs as made from the seed, made again (the
        control's cut scalars are not what the reference commits to), and
        the lanes that hold a point."""
        sets = [x.cpu().numpy() for x in self.make_scalars()]
        return sets, (self.lanes() != self.identity_lane).cpu().numpy()

    def release(self) -> None:
        self.points = self.scalars = self.entry = None


def cut_scalars(x: torch.Tensor) -> torch.Tensor:
    """The control's scalars: each canonical scalar k = x R^-1 mod q cut to
    its low 253 bits, back in Montgomery limbs (a commitment that drops
    the top scalar bits, as a narrower digit count would)."""
    from reference.params import FR_R, Q

    r_inv = pow(FR_R, -1, Q)
    host = x.cpu().numpy().astype("<u2")
    out = np.zeros(host.shape, dtype=np.int32)
    for i in range(host.shape[1]):
        k = int.from_bytes(host[:, i].tobytes(), "little") * r_inv % Q
        v = (k % (1 << 253)) * FR_R % Q
        out[:, i] = np.frombuffer(v.to_bytes(32, "little"), "<u2")
    return torch.from_numpy(out).to(x.device)


def check(ref_inputs, answers, seed: int):
    """({name: (value, limit)}, failed call indexes): every call's point
    against the reference's commitment of its scalar set; an exact
    comparison, limit 0."""
    sets, holds_point = ref_inputs
    want = {}
    failed = set()
    for i, point in answers:
        s = i % len(sets)
        if s not in want:
            want[s] = commitment.expected(sets[s], holds_point)
        if commitment.affine(point) != want[s]:
            failed.add(i)
    return {"wrong_commitments": (len(failed), 0)}, failed
