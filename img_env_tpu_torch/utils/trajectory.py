"""Per-episode kinematic path statistics (the port's own copy of
``img_env_tpu.utils.trajectory``; numpy only).

Equivalent of TrajectoryPathHelper (envs/wrapper/evaluation_wrapper/utils.py):
jerk (2nd difference of v/w over dt), variance, sign-change counts, averages.
Works on plain numpy arrays collected per episode.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class TrajectoryStats:
    def __init__(self, dt: float):
        self.dt = dt
        self.v: List[float] = []
        self.w: List[float] = []

    def add_vw(self, v: float, w: float) -> None:
        self.v.append(float(v))
        self.w.append(float(w))

    def clear(self) -> None:
        self.v.clear()
        self.w.clear()

    @property
    def steps(self) -> int:
        return len(self.v)

    def path_time(self) -> float:
        return round(len(self.v) * self.dt, 4)

    def w_variance(self) -> float:
        return round(float(np.var(self.w)) if self.w else 0.0, 4)

    def v_avg(self) -> float:
        return round(float(np.average(self.v)) if self.v else 0.0, 4)

    def w_avg(self) -> float:
        return round(float(np.average(np.abs(self.w))) if self.w else 0.0, 4)

    def w_zero(self) -> int:
        """Sign-change count with the reference's zero-handling
        (utils.py:74-86): a zero sample counts a crossing if the previous
        nonzero... (the reference compares against the immediately previous
        sample, treating w==0 with prior nonzero as a crossing)."""
        tmp = 0.0
        zeros = 0
        for w in self.w:
            if w == 0:
                if tmp != 0:
                    zeros += 1
            else:
                if (w > 0 and tmp < 0) or (w < 0 and tmp > 0):
                    zeros += 1
            tmp = w
        return zeros

    def _jerk(self, arr) -> tuple:
        if len(arr) < 3:
            return 0.0, 0.0
        acc = np.diff(arr) / self.dt
        jrk = np.diff(acc) / self.dt
        return float(np.average(np.abs(jrk))), float(np.average(np.abs(acc)))

    def v_jerk(self) -> float:
        return round(self._jerk(self.v)[0], 4)

    def w_jerk(self) -> float:
        return round(self._jerk(self.w)[0], 4)

    def v_acc(self) -> float:
        return round(self._jerk(self.v)[1], 4)

    def w_acc(self) -> float:
        return round(self._jerk(self.w)[1], 4)

    def metric_dict(self) -> Dict:
        return {
            "v_avg": self.v_avg(),
            "w_avg": self.w_avg(),
            "v_acc": self.v_acc(),
            "w_acc": self.w_acc(),
            "v_jerk": self.v_jerk(),
            "w_jerk": self.w_jerk(),
            "w_zero": self.w_zero(),
            "path_time": self.path_time(),
            "steps": self.steps,
        }
