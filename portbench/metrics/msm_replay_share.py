"""The share of the traced calls' MSMs that ran from a CUDA graph: of the
outermost `msm` spans in the traced window, those that hold an
`msm.replay` span (the program's replay of the MSM's captured launch
sequence, `bls12_381_torch/ops/msm.py`).

One reader for the groups `.msm` and `.blob`, each moving its own end-to-
end metric; None untraced, where the program records no spans or no MSM
in the window, or where it has no MSM graphs at all (no `GRAPHS` counter
in `bls12_381_torch.kernels`)."""

import stages


def has_graphs() -> bool:
    try:
        from bls12_381_torch import kernels
    except ImportError:
        return False
    return hasattr(kernels, "GRAPHS")


def share(run, spans=None) -> float | None:
    if run.trace is None or not has_graphs():
        return None
    if spans is None:
        spans = stages.program_spans()
    window = stages.in_window(spans or [], run.trace)
    tops = stages.outermost(window, "msm")
    if not tops:
        return None
    kids: dict = {}
    for s in window:
        kids.setdefault(s["parent"], []).append(s)

    def replayed(s) -> bool:
        return any(k["name"] == "msm.replay" or replayed(k)
                   for k in kids.get(s["id"], []))

    return sum(replayed(s) for s in tops) / len(tops)


def read(run):
    return share(run)
