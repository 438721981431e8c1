"""Batched operations: the radix-2 NTT over Fr, Pippenger MSM, and the
resident validator key table summed by index (`aggregate`)."""

from . import aggregate, msm, ntt  # noqa: F401
