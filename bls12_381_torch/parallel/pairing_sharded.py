"""The batched pairing with the batch sharded over a mesh.

Counterpart of `bls12_381_tpu/parallel/pairing_sharded.py`.  Pairings are
independent, so each rank runs the port's Miller loop (and final
exponentiation) on its shard with no exchange in between:

  * element-wise: each rank pairs its shard, then ONE all_gather of the
    packed Fp12 values [12, 24, b] makes the batch whole on every rank;
  * aggregate (`multi_miller_loop` across ranks): each rank multiplies its
    Miller values with the port's halving tree (`_tree_product`), then per
    mesh axis, inner axis first, one all_gather of the packed Fp12 value
    [12, 24] and the tree product of the gathered ones; one final
    exponentiation at the end (none with final_exp=False).

Identity lanes keep their masks: the masks shard with the points.
"""

from __future__ import annotations

import torch

from ..pairing.pairing import (_tree_product, final_exponentiation,
                               miller_loop_batched, prepare_g2)
from ..utils import scans
from . import mesh as mesh_mod


def _pack(f) -> torch.Tensor:
    return torch.stack(scans.tree_leaves(f))  # [12, 24, *batch]


def _unpack(like, packed):
    it = iter(packed)
    return scans.tree_map(lambda _: next(it), like)


def pairing_sharded(mesh, p_aff, q_aff, aggregate: bool = False,
                    final_exp: bool = True):
    """e(P_i, Q_i) for affine batches (xp, yp, inf) and ((x0, x1), (y0, y1),
    inf) over the last axis, the same on every rank, sharded over the mesh.

    aggregate=False: the element-wise pairings [*, B] on every rank,
    final-exponentiated whatever final_exp says (as the JAX function).
    aggregate=True: the product of all the pairings with ONE final
    exponentiation (the multi_miller_loop pattern, pairings.rs:554-603,
    across ranks), batch shape (); final_exp=False skips it and returns
    the product of the raw Miller values."""
    p, q = mesh_mod.shard_batch(mesh, (p_aff, q_aff))
    f = miller_loop_batched(p, prepare_g2(q))
    if not aggregate:
        f = final_exponentiation(f)
        return _unpack(f, mesh_mod.gather_batch(_pack(f)))
    f = _tree_product(f)
    for axis in mesh_mod.reduce_axes_inner_first(mesh):
        f = _tree_product(_unpack(f, mesh_mod.all_gather_axis(
            mesh, _pack(f), axis)))
    return final_exponentiation(f) if final_exp else f
