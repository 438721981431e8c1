"""1 - (union of device activity) / (host-clock span of the traced
calls).

One reader for every group of cells (`.msm`, `.blob`, `.verify`,
`.block`), each group moving its own end-to-end metric."""

import devtrace


def read(run):
    return None if run.trace is None else devtrace.device_idle_share(run.trace)
