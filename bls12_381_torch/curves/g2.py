"""G2 over Fp2 (y^2 = x^3 + 4(u + 1)): the part the pairing needs."""

from __future__ import annotations

import torch

from .. import params
from ..fields import tower as tw


def generator_affine(batch=(), device="cuda"):
    """The standard G2 generator, affine (x, y, infinity), broadcast over a
    batch shape."""
    x, y = params.G2_GEN
    return (
        tw.fp2_const(x, batch, device),
        tw.fp2_const(y, batch, device),
        torch.zeros(tuple(batch), dtype=torch.bool, device=device),
    )
