"""Seconds from the process's start to the first timed call: imports, the
card, the kernel libraries (built on a checkout's first run), the inputs
and the warm-up calls of the cell's own shapes."""


def read(run):
    return run.setup_s
