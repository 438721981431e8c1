"""Pippenger multi-scalar multiplication with the points sharded over a
mesh.

Counterpart of `bls12_381_tpu/parallel/msm_sharded.py`: every rank runs the
port's whole local MSM (`ops.msm.msm_g1` / `msm_g2`) on its shard, so the
buckets stay on the rank and nothing is scattered across ranks; then the
partial points combine axis by axis, inner axis first, each by ONE
all_gather of the packed point (3 or 6 coordinates [24] as one tensor)
and a chain of group additions in rank order (the JAX `_gather_tree_add`,
which despite its name adds in a chain).  Every rank adds the same points
in the same order, so the result is replicated limb for limb.
"""

from __future__ import annotations

import torch

from ..curves import g1 as G1
from ..curves import g2 as G2
from ..ops import msm as msm_mod
from ..utils import scans
from . import mesh as mesh_mod


def _gather_chain_add(mesh, curve_mod, point, axis: str):
    """The partial points of every rank along `axis`, added in rank
    order."""
    rows = scans.tree_leaves(point)
    packed = mesh_mod.all_gather_axis(mesh, torch.stack(rows), axis)
    it = iter(packed)  # [k, 24, c] -> k coordinates [24, c]
    parts = scans.tree_map(lambda _: next(it), point)
    acc = scans.tree_map(lambda t: t[..., 0], parts)
    for i in range(1, packed.shape[-1]):
        acc = curve_mod.add(acc, scans.tree_map(lambda t: t[..., i], parts))
    return acc


def _sharded(mesh, curve_mod, local_msm, points, scalars):
    points, scalars = mesh_mod.shard_batch(mesh, (points, scalars))
    acc = local_msm(points, scalars)
    for axis in mesh_mod.reduce_axes_inner_first(mesh):
        acc = _gather_chain_add(mesh, curve_mod, acc, axis)
    return acc


def msm_g1_sharded(mesh, points_proj, scalars_mont, c: int = 8,
                   glv: bool = True):
    """sum_i [s_i] P_i over G1 with the batch sharded over the mesh:
    projective points (x, y, z) [24, B] and Montgomery Fr scalars [16, B],
    the same on every rank, B a multiple of the mesh size.  Returns the
    projective sum (batch shape ()) on every rank; glv as in `msm_g1`."""
    return _sharded(mesh, G1,
                    lambda p, s: msm_mod.msm_g1(p, s, c=c, glv=glv),
                    points_proj, scalars_mont)


def msm_g2_sharded(mesh, points_proj, scalars_mont, c: int = 8,
                   gls: bool = True):
    """msm_g2 with the batch sharded over the mesh (points: tuples of Fp2
    coordinates), as msm_g1_sharded; gls as in `msm_g2` (subgroup points
    only)."""
    return _sharded(mesh, G2,
                    lambda p, s: msm_mod.msm_g2(p, s, c=c, gls=gls),
                    points_proj, scalars_mont)
