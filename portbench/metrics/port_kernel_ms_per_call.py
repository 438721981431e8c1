"""Device ms per traced call in the program's own kernels
(`devtrace.PORT_KERNELS`).

One reader for every group of cells (`.msm`, `.blob`, `.verify`,
`.block`), each group moving its own end-to-end metric."""

import devtrace


def read(run):
    return None if run.trace is None else \
        devtrace.port_kernel_ms_per_call(run.trace)
