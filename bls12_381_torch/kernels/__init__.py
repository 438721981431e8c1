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
        self.sop = self.sqr = self.plan_exec = 0
        self.sop_fr = self.butterfly = self.fold_planned = 0
        self.pow_fixed = self.pow_fixed_fr = self.fp2_pow_fixed = 0
        self.sha256 = self.xmd_sha256 = self.shake = 0
        self.copied_rows = 0
        self.plan_exec_by_plan.clear()

    def snapshot(self) -> dict:
        return {"sop": self.sop, "sqr": self.sqr, "plan_exec": self.plan_exec,
                "sop_fr": self.sop_fr, "butterfly": self.butterfly,
                "fold_planned": self.fold_planned,
                "pow_fixed": self.pow_fixed, "pow_fixed_fr": self.pow_fixed_fr,
                "fp2_pow_fixed": self.fp2_pow_fixed,
                "sha256": self.sha256, "xmd_sha256": self.xmd_sha256,
                "shake": self.shake,
                "copied_rows": self.copied_rows,
                "plan_exec_by_plan": dict(self.plan_exec_by_plan)}


LAUNCHES = LaunchCounts()
