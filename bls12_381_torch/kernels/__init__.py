"""Hand-written Hopper kernels of the port and their launch counts: the
Montgomery row, square, power and butterfly kernels (`mont.py`), the plan
kernel (`plan_exec.py`) and the device hash expanders (`sha256.py`:
SHA-256 and expand_message_xmd; `keccak.py`: the SHAKE sponge and
expand_message_xof), each beside its plain PyTorch version.

Each wrapper adds one to its count in `LAUNCHES` where it launches its CUDA
kernel, and nowhere else (a CPU tensor takes the plain PyTorch version and
counts nothing), so a run can show which kernels its path went through.
`copied_rows` is not a launch count: it counts the operands `mont.sop_rows`
had to copy before a launch because their batch axes do not collapse to two
lane strides (on either device, so the CPU tests see it too).  A launch
recorded into a CUDA graph's capture is not counted; each replay of the
graph adds the counts its capture recorded (`utils/graphs.py`), so the
counts stay those of the launches the card ran.  `GRAPHS` counts what
those graphs did, `AGGREGATES` the key sums of `ops/aggregate.py`,
`BUCKETS` the bucket sums of `ops/msm.py` (replays add them as they add
launches), `CELLS` the cell-proof batches of `ops/kzg.py`.
"""

from __future__ import annotations

import collections
import dataclasses


@dataclasses.dataclass
class LaunchCounts:
    sop: int = 0
    sqr: int = 0
    plan_exec: int = 0
    sop_fr: int = 0
    butterfly: int = 0
    fold_planned: int = 0
    pow_fixed: int = 0
    pow_fixed_fr: int = 0
    fp2_pow_fixed: int = 0
    sha256: int = 0
    xmd_sha256: int = 0
    shake: int = 0
    copied_rows: int = 0
    plan_exec_by_plan: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            if f.name == "plan_exec_by_plan":
                self.plan_exec_by_plan.clear()
            else:
                setattr(self, f.name, f.default)

    def snapshot(self) -> dict:
        out = dataclasses.asdict(self)
        out["plan_exec_by_plan"] = dict(self.plan_exec_by_plan)
        return out

    def since(self, before: dict) -> dict:
        """The counts added since the snapshot `before`."""
        now = self.snapshot()
        out = {k: v - before[k] for k, v in now.items()
               if k != "plan_exec_by_plan"}
        out["plan_exec_by_plan"] = dict(
            collections.Counter(now["plan_exec_by_plan"])
            - collections.Counter(before["plan_exec_by_plan"]))
        return out

    def add(self, counts: dict) -> None:
        """Add counts in the form of `since`'s."""
        for k, v in counts.items():
            if k == "plan_exec_by_plan":
                self.plan_exec_by_plan.update(v)
            else:
                setattr(self, k, getattr(self, k) + v)

    def restore(self, snap: dict) -> None:
        """Set every count back to a snapshot's."""
        self.reset()
        self.add(snap)

    def port_total(self) -> int:
        """Every launch of the port's kernels so far: the sum of the launch
        counts (`copied_rows` counts copies, `plan_exec_by_plan` splits
        `plan_exec`)."""
        return sum(getattr(self, name) for name in _LAUNCH_FIELDS)


_LAUNCH_FIELDS = tuple(f.name for f in dataclasses.fields(LaunchCounts)
                       if f.name not in ("copied_rows", "plan_exec_by_plan"))
LAUNCHES = LaunchCounts()


class _Counts:
    """Counters of a dataclass of ints: reset and read as a dict."""

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)

    def since(self, before: dict) -> dict:
        """The counts added since the snapshot `before`."""
        return {k: v - before[k] for k, v in self.snapshot().items()}

    def add(self, counts: dict) -> None:
        for k, v in counts.items():
            setattr(self, k, getattr(self, k) + v)

    def restore(self, snap: dict) -> None:
        for k, v in snap.items():
            setattr(self, k, v)


@dataclasses.dataclass
class GraphCounts(_Counts):
    """What the CUDA graphs did (`utils/graphs.py`): graphs captured, calls
    replayed from one, calls on the card run eagerly (the first at a shape,
    any under a profiler before its shape was captured, and every call at
    a shape whose capture raised or whose graph was too large to keep),
    captures that raised, and graphs too large to keep."""
    captures: int = 0
    replays: int = 0
    eager: int = 0
    fallbacks: int = 0
    oversize: int = 0


GRAPHS = GraphCounts()


@dataclasses.dataclass
class AggregateCounts(_Counts):
    """What the key sums of `ops/aggregate.py` did, on either device:
    calls of `KeyRegistry.aggregate`, the sets they were given and the
    keys they gathered."""
    calls: int = 0
    sets: int = 0
    keys: int = 0


AGGREGATES = AggregateCounts()


@dataclasses.dataclass
class BucketCounts(_Counts):
    """The bucket sums of `ops/msm.py` `segment_sums` (the MSM's buckets,
    the registry's key sets): calls that took the fold (a card) and the
    segmented scan (the CPU), the lanes folded and the fold's levels."""
    fold: int = 0
    scan: int = 0
    lanes: int = 0
    levels: int = 0


BUCKETS = BucketCounts()


@dataclasses.dataclass
class CellCounts(_Counts):
    """What `ops/kzg.py` `verify_cell_kzg_proof_batch` did, on either
    device: calls, the cells they were given, the commitments left after
    deduplication, and the batches refused at decoding (a length, index,
    point or field element the spec refuses), refused by the pairing
    check, and accepted.  It counts on the host, outside every graph's
    body, so a replay adds nothing to it."""
    calls: int = 0
    cells: int = 0
    commitments: int = 0
    refused_decode: int = 0
    refused_pairing: int = 0
    accepted: int = 0


CELLS = CellCounts()
