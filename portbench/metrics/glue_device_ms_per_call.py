"""Device ms per traced call outside the program's own kernels: torch's
kernels, copies and fills (the glue of limbs.py, fields/, utils/scans.py
and the torch code of the paths).

One reader for every group of cells (`.msm`, `.blob`, `.verify`,
`.block`), each group moving its own end-to-end metric."""

import devtrace


def read(run):
    return None if run.trace is None else \
        devtrace.glue_device_ms_per_call(run.trace)
