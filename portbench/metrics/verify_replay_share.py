"""The share of the traced calls' verify stages that ran from a CUDA graph:
of the outermost `pairing`, `h2c` and `codec.decode` spans in the traced
window, those that hold the replay span of their stage (`pairing.replay`,
`h2c.replay`, `codec.replay`: the program's replay of the stage's captured
launch sequence, `bls12_381_torch/pairing/pairing.py`,
`hash_to_curve/h2c.py`, `curves/g1.py` and `g2.py`).

One reader for the groups `.block`, `.verify` and `.agg`, each moving its
own end-to-end metric; None untraced, where the program records no spans
or no verify stage in the window, or where it has no graphs at all (no
`GRAPHS` counter in `bls12_381_torch.kernels`)."""

import stages

REPLAYS = {"pairing": "pairing.replay", "h2c": "h2c.replay",
           "codec.decode": "codec.replay"}


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
    kids: dict = {}
    for s in window:
        kids.setdefault(s["parent"], []).append(s)

    def replayed(s, name) -> bool:
        return any(k["name"] == name or replayed(k, name)
                   for k in kids.get(s["id"], []))

    tops = [(s, replay) for stage, replay in REPLAYS.items()
            for s in stages.outermost(window, stage)]
    if not tops:
        return None
    return sum(replayed(s, replay) for s, replay in tops) / len(tops)


def read(run):
    return share(run)
