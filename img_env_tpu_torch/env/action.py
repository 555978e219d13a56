"""Action containers mirroring the reference API (envs/action/action.py);
the port's own copy of ``img_env_tpu.env.action``."""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ContinuousAction:
    """(v, w[, beep]) command (action.py:4-20)."""

    v: float
    w: float
    beep: float = 0.0

    def reverse(self) -> Tuple[float, float, float]:
        return (self.v, self.w, self.beep)


class DiscreteActions:
    """Indexed (v, w[, beep]) table; v >= 0 asserted (action.py:23-38)."""

    def __init__(self, actions: Sequence[Sequence[float]]):
        self.actions: List[ContinuousAction] = []
        for a in actions:
            assert a[0] >= 0, "linear velocity must be non-negative"
            self.actions.append(ContinuousAction(*a))

    def __getitem__(self, i: int) -> ContinuousAction:
        return self.actions[int(i)]

    def __len__(self) -> int:
        return len(self.actions)
