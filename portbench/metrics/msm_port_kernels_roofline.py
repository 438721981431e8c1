"""The least time of a 2^20-point commitment's work on one H100, in % of
the time the program's own kernels took per traced call
(`roofline.port_kernels_share`)."""

from roofline import port_kernels_share as read  # noqa: F401
