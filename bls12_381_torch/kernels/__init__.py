"""Hand-written Hopper kernels of the port and their launch counts.

Each wrapper adds one to its count in `LAUNCHES` where it launches its CUDA
kernel, and nowhere else (a CPU tensor takes the plain PyTorch version and
counts nothing), so a run can show which kernels its path went through.
"""

from __future__ import annotations

import collections
import dataclasses


@dataclasses.dataclass
class LaunchCounts:
    sop: int = 0
    sqr: int = 0
    plan_exec: int = 0
    plan_exec_by_plan: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def reset(self) -> None:
        self.sop = self.sqr = self.plan_exec = 0
        self.plan_exec_by_plan.clear()

    def snapshot(self) -> dict:
        return {"sop": self.sop, "sqr": self.sqr, "plan_exec": self.plan_exec,
                "plan_exec_by_plan": dict(self.plan_exec_by_plan)}


LAUNCHES = LaunchCounts()
