"""Batched operations over the fields: the radix-2 NTT over Fr."""

from . import ntt  # noqa: F401
