"""Launches of the program's own kernels per traced call, counted by the
program itself (`kernels.LAUNCHES.port_total()`) over its top-level spans:
`msm`, `codec.decode`, `h2c`, `pairing`.

One reader for the groups `.msm`, `.blob`, `.verify`, `.block`, each
moving its own end-to-end metric; None untraced or where the program
records no spans (`stages.py`)."""

import stages


def read(run):
    return stages.port_launches_per_call(run)
