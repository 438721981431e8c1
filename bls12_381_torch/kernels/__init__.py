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
lane strides (on either device, so the CPU tests see it too).
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

    def port_total(self) -> int:
        """Every launch of the port's kernels so far: the sum of the launch
        counts (`copied_rows` counts copies, `plan_exec_by_plan` splits
        `plan_exec`)."""
        return sum(getattr(self, name) for name in _LAUNCH_FIELDS)


_LAUNCH_FIELDS = tuple(f.name for f in dataclasses.fields(LaunchCounts)
                       if f.name not in ("copied_rows", "plan_exec_by_plan"))
LAUNCHES = LaunchCounts()
