"""Batched operations: the radix-2 NTT over Fr and Pippenger MSM."""

from . import msm, ntt  # noqa: F401
