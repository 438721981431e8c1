"""Device kernels launched per traced call, the program's and torch's
(copies and fills not counted).

One reader for every group of cells (`.msm`, `.blob`, `.verify`,
`.block`), each group moving its own end-to-end metric."""

import devtrace


def read(run):
    return None if run.trace is None else devtrace.launches_per_call(run.trace)
