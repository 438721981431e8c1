"""Curve groups G1 and G2 over the complete Weierstrass group law."""

from . import g1, g2  # noqa: F401
