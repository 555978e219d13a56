"""Hardware frontend: the RealEnv surface without ROS (torch port of
``img_env_tpu.env.hardware_env``).

The reference's ``RealEnv`` (envs/env/real_env.py) exposes the same Gym
contract as the simulator but sources observations from a real robot:
laser scans, odometry, a pedestrian tracker, and TF goal transforms.  Here
the transport is dependency-injected — the host supplies the latest sensor
samples through plain-data callbacks (a ROS1/ROS2/zmq bridge is a few lines
on the robot side) and this class reproduces the reference's processing:

  * laser frame re-projection (``_deal_scan``, real_env.py:370-398)
  * inf/nan laser normalization (``_norm_lasers``, real_env.py:321-336)
  * SPENCER-style tracked peds -> 7-vectors + 3-channel ped map
    (``_ped_state``, real_env.py:267-316, including the -x+3 image flip)
  * goal-in-base-frame state vector (``get_state_goal``, real_env.py:338-345)

Everything is numpy at hardware rates (10-30 Hz) but the log-polar sensor
map synthesized from a scan, which runs on ``device`` (the card by
default); the outputs match the simulator's observation layout so one
policy drives both.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class ScanSample:
    ranges: np.ndarray
    angle_min: float
    angle_increment: float
    in_base_frame: bool = True
    laser_tf: Optional[np.ndarray] = None   # [3,3] SE(2) laser->base


@dataclasses.dataclass
class TrackedPed:
    xy_world: Tuple[float, float]
    v_world: Tuple[float, float]


class HardwareEnv:
    """Gym-shaped facade over injected hardware samples (single robot)."""

    def __init__(self, cfg, send_cmd: Optional[Callable] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.send_cmd = send_cmd or (lambda v, w: None)
        self.laser_max = float(cfg.laser_max)
        self.laser_norm = bool(cfg.laser_norm)
        self.max_ped = int(cfg.max_ped)
        self.ped_vec_dim = int(cfg.ped_vec_dim)
        self.ped_image_size = tuple(cfg.ped_image_size)
        self.ped_image_r = float(cfg.ped_image_r)
        self.ped_map_resolution = 6.0 / self.ped_image_size[0]
        self.robot_radius = float(cfg.robot_radius)
        self.control_hz = float(cfg.control_hz)
        self._scan: Optional[ScanSample] = None
        self._image: Optional[np.ndarray] = None
        self._peds: List[TrackedPed] = []
        self._base_tf = np.eye(3)        # world->base SE(2)
        self._goal_world = np.zeros(2)
        self._last_step_t: Optional[float] = None

    # -- host feeds --------------------------------------------------------
    def feed_scan(self, scan: ScanSample) -> None:
        self._scan = scan

    def feed_image(self, image: np.ndarray) -> None:
        """Camera / laser-image sample for the ``sensor_maps`` surface —
        the reference's ``laser_image`` topic feeding ``image_last``
        (real_env.py:139, 233-240; gazebo_env.py:258).  Expected
        [image_size] floats in [0, 1]; without a fed image ``observe``
        synthesizes the map from the scan instead."""
        self._image = np.asarray(image, np.float32)

    def feed_peds(self, peds: Sequence[TrackedPed]) -> None:
        self._peds = list(peds)

    def feed_pose(self, x: float, y: float, yaw: float) -> None:
        c, s = math.cos(yaw), math.sin(yaw)
        world_from_base = np.asarray([[c, -s, x], [s, c, y], [0, 0, 1.0]])
        self._base_tf = np.linalg.inv(world_from_base)

    def set_goal(self, x: float, y: float) -> None:
        self._goal_world = np.asarray([x, y], np.float64)

    # -- reference-matching processing --------------------------------------
    def deal_scan(self, scan: ScanSample) -> np.ndarray:
        """Re-project ranges measured in the laser frame into base-frame
        distances (real_env.py:370-398)."""
        if scan.in_base_frame or scan.laser_tf is None:
            return np.asarray(scan.ranges, np.float64)
        ang = scan.angle_min + scan.angle_increment * np.arange(
            len(scan.ranges))
        pts = np.stack([scan.ranges * np.cos(ang),
                        scan.ranges * np.sin(ang),
                        np.ones_like(ang)])
        xyz = scan.laser_tf @ pts
        return np.hypot(xyz[0], xyz[1])

    def norm_lasers(self, ranges: np.ndarray) -> np.ndarray:
        """inf -> max, nan -> max, optional /laser_max (real_env.py:321-336)."""
        r = np.asarray(ranges, np.float64).copy()
        if self.laser_norm:
            r = r / self.laser_max
            r[np.isinf(r)] = 1.0
            r[np.isnan(r)] = 1.0
        else:
            r[np.isinf(r)] = self.laser_max
            r = np.clip(r, 0, self.laser_max)
            r[np.isnan(r)] = self.laser_max
        return r

    def ped_state(self):
        """Tracked peds -> (ped vector [1+7*max_ped], ped map [3,H,W])
        (real_env.py:267-316)."""
        vec = np.zeros(self.max_ped * self.ped_vec_dim + 1, np.float32)
        img = np.zeros((3,) + self.ped_image_size, np.float32)
        res = self.ped_map_resolution
        j = 0
        for ped in self._peds[: self.max_ped]:
            p = self._base_tf @ np.asarray([ped.xy_world[0], ped.xy_world[1], 1.0])
            tmx, tmy = float(p[0]), float(p[1])
            vx, vy = ped.v_world
            base = j * self.ped_vec_dim
            vec[base + 1:base + 8] = (
                tmx, tmy, vx, vy, self.ped_image_r * 2,
                self.ped_image_r * 2 + self.robot_radius,
                math.hypot(tmx, tmy))
            j += 1
            if abs(tmx) > 3 or abs(tmy) > 3:
                continue
            ix, iy = -tmx + 3, -tmy + 3
            lo_x = int((ix - self.ped_image_r) // res)
            hi_x = int((ix + self.ped_image_r) // res)
            lo_y = int((iy - self.ped_image_r) // res)
            hi_y = int((iy + self.ped_image_r) // res)
            for jj in range(lo_x, hi_x):
                for kk in range(lo_y, hi_y):
                    if 0 <= jj < self.ped_image_size[0] and 0 <= kk < self.ped_image_size[1]:
                        d2 = (((jj + 0.5) * res - ix) ** 2
                              + ((kk + 0.5) * res - iy) ** 2)
                        if d2 < self.ped_image_r ** 2:
                            img[:, jj, kk] = 1.0, vx, vy
        vec[0] = j
        return vec, img

    def state_goal(self) -> np.ndarray:
        """Goal pose in the base frame (real_env.py:338-345)."""
        g = self._base_tf @ np.asarray([self._goal_world[0],
                                        self._goal_world[1], 1.0])
        yaw = math.atan2(-self._base_tf[0, 1], self._base_tf[0, 0])
        return np.asarray([g[0], g[1], -yaw], np.float64)

    # -- gym surface ---------------------------------------------------------
    def observe(self):
        scan = self.deal_scan(self._scan) if self._scan else np.full(
            self.cfg.range_total, self.laser_max)
        lasers = self.norm_lasers(scan)
        ped_vec, ped_map = self.ped_state()
        vec = self.state_goal()[: self.cfg.state_dim]
        return {
            "vector_states": vec[None],
            "sensor_maps": self.sensor_map(scan)[None],
            "lasers": lasers[None],
            "ped_vector_states": ped_vec[None],
            "ped_maps": ped_map[None],
        }

    def sensor_map(self, scan: np.ndarray) -> np.ndarray:
        """[h, w] image surface: the fed camera/laser image when present
        (``image_last``, real_env.py:139), else the scan's log-polar
        occupancy map (the reference's documented alternative,
        real_env.py:141 / _trans_lidar_log_map) — so an image policy
        checkpoint runs through the hardware facade either way."""
        h, w = self.cfg.image_size
        if self._image is not None:
            img = self._image
            if img.shape[-2:] != (h, w):
                ri = (np.arange(h) * img.shape[-2] // h)
                ci = (np.arange(w) * img.shape[-1] // w)
                img = img[..., ri[:, None], ci[None, :]]
            return np.asarray(img, np.float32).reshape(h, w)
        from img_env_tpu_torch.utils.lidar import trans_lidar_log_map

        scan = torch.as_tensor(np.asarray(scan, np.float32),
                               device=self.device)
        return trans_lidar_log_map(scan, length=h).cpu().numpy()

    def step(self, action):
        v, w = float(action[0]), float(action[1])
        self.send_cmd(v, w)
        # real-time pacing: one control period per step (TimeControl)
        now = time.perf_counter()
        if self._last_step_t is not None:
            rem = self.control_hz - (now - self._last_step_t)
            if rem > 0:
                time.sleep(rem)
        self._last_step_t = time.perf_counter()
        obs = self.observe()
        d = float(np.hypot(obs["vector_states"][0, 0], obs["vector_states"][0, 1]))
        done = d < 0.3
        return obs, 0.0, np.asarray([int(done)]), {
            "arrive": done, "dones_info": np.asarray([5 if done else 0])}

    def reset(self):
        self._last_step_t = None
        return self.observe()
