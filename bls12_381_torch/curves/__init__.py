"""Curve groups: the G2 generator the pairing needs."""

from . import g2  # noqa: F401
