"""Entry point of the port's main path: the batched optimal-ate pairing.

`entry()` mirrors `__graft_entry__.entry()` of the JAX package: it returns
the pairing function and example inputs e([i+1]G1, [2i+1]G2), i < batch, on
the device (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import torch

from . import hostmath as hm
from . import params
from .fields import fp, tower as tw
from .limbs import resolve_device
from .pairing import pairing


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
