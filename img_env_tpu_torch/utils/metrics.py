"""Evaluation metrics — TestEpisodeWrapper equivalent (the port's own copy
of ``img_env_tpu.utils.metrics``; numpy only).

Tracks arrive/static-collision/ped-collision/robot-collision/stuck rates,
average steps to arrival, speed averages and smoothness statistics
(envs/wrapper/evaluation_wrapper/TestEpisodeWrapper.py:8-119), using the
``dones_info`` codes {1,2,3,5,10}.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from img_env_tpu_torch.constants import (
    DONE_ARRIVE,
    DONE_COLL_PED,
    DONE_COLL_ROBOT,
    DONE_COLL_STATIC,
    DONE_TIMEOUT,
)
from img_env_tpu_torch.utils.trajectory import TrajectoryStats


class EpisodeMetrics:
    def __init__(self, cfg):
        self.dt = float(cfg.control_hz)
        self.episodes = 0
        self.arrive = 0
        self.static_coll = 0
        self.ped_coll = 0
        self.robot_coll = 0
        self.stuck = 0
        self.arrive_steps = 0
        self.speed_steps = 0
        self.v_sum = 0.0
        self.w_sum = 0.0
        self.tmp_steps = 0
        self.traj = TrajectoryStats(self.dt)
        self.w_variance = []
        self.v_jerk = []
        self.w_jerk = []
        self.w_zero = []

    def add_step(self, info: Dict) -> None:
        self.tmp_steps += 1
        speeds = np.asarray(info.get("speeds"))
        if speeds is not None and speeds.size:
            self.v_sum += float(speeds[0, 0])
            self.w_sum += abs(float(speeds[0, 1]))
            self.traj.add_vw(speeds[0, 0], speeds[0, 1])

    def end_episode(self, dones_info) -> None:
        if self.tmp_steps <= 3:  # degenerate episodes skipped like reference
            self.tmp_steps = 0
            self.traj.clear()
            return
        t = int(np.asarray(dones_info).reshape(-1)[0])
        self.episodes += 1
        self.speed_steps += self.tmp_steps
        if t == DONE_ARRIVE:
            self.arrive += 1
            self.arrive_steps += self.tmp_steps
        elif t == DONE_TIMEOUT:
            self.stuck += 1
        elif t == DONE_COLL_STATIC:
            self.static_coll += 1
        elif t == DONE_COLL_PED:
            self.ped_coll += 1
        elif t == DONE_COLL_ROBOT:
            self.robot_coll += 1
        self.w_variance.append(self.traj.w_variance())
        self.v_jerk.append(self.traj.v_jerk())
        self.w_jerk.append(self.traj.w_jerk())
        self.w_zero.append(self.traj.w_zero())
        self.traj.clear()
        self.tmp_steps = 0

    def summary(self) -> Dict:
        e = max(self.episodes, 1)
        return {
            "episodes": self.episodes,
            "arrive_rate": self.arrive / e,
            "static_coll_rate": self.static_coll / e,
            "ped_coll_rate": self.ped_coll / e,
            "other_coll_rate": self.robot_coll / e,
            "stuck_rate": self.stuck / e,
            "avg_arrive_steps": self.arrive_steps / max(1, self.arrive),
            "avg_v": self.v_sum / max(1, self.speed_steps + self.tmp_steps),
            "avg_w": self.w_sum / max(1, self.speed_steps + self.tmp_steps),
            "avg_w_variance": float(np.sum(self.w_variance)) / e,
            "avg_v_jerk": float(np.sum(self.v_jerk)) / e,
            "avg_w_jerk": float(np.sum(self.w_jerk)) / e,
            "avg_w_zero": float(np.sum(self.w_zero)) / e,
        }


def batched_dones_summary(dones_info: np.ndarray) -> Dict:
    """Vectorized outcome rates over a [episodes, robots] dones_info array —
    the on-device analogue reduced with psum in sharded evaluation."""
    d = np.asarray(dones_info)
    tot = max(d.size, 1)
    return {
        "arrive_rate": float((d == DONE_ARRIVE).sum()) / tot,
        "static_coll_rate": float((d == DONE_COLL_STATIC).sum()) / tot,
        "ped_coll_rate": float((d == DONE_COLL_PED).sum()) / tot,
        "other_coll_rate": float((d == DONE_COLL_ROBOT).sum()) / tot,
        "stuck_rate": float((d == DONE_TIMEOUT).sum()) / tot,
    }
