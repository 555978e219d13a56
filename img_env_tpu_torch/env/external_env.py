"""External-simulator frontend (the GazeboEnv contract, without ROS; torch
port of ``img_env_tpu.env.external_env``).

The reference's ``GazeboEnv`` (envs/env/gazebo_env.py:144-316) drives a
Gazebo instance through service calls and topics: pause/unpause physics,
``set_model_state`` to teleport the robot at reset, ``get_model_state`` for
the TF goal-in-base state (gazebo_env.py:465-476), a laser topic, a contact
topic counted between polls, and a ``cmd_vel`` publisher.  Collision is
"min laser below threshold OR hard contact" (gazebo_env.py:294-308) and
arrival is goal distance < 1 m.

Here the same surface is transport-injected, like ``HardwareEnv``: the host
supplies plain-data callbacks (a rospy/rclpy/zmq bridge is a few lines on
the simulator side — each callback maps 1:1 to a reference service/topic),
and this class reproduces the reference's control flow and processing.
Works against any external simulator that can answer the six callbacks,
not just Gazebo.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Sequence

import numpy as np

from img_env_tpu_torch.env.hardware_env import HardwareEnv, ScanSample, TrackedPed


@dataclasses.dataclass
class ExternalSimTransport:
    """Callback bundle mapping 1:1 to the reference's Gazebo services.

    get_contact must report "any hard contact since the last call" and
    clear its counter (GazeboSimulation.get_hard_collision,
    gazebo_env.py:87-92).
    """

    get_scan: Callable[[], ScanSample]
    get_model_state: Callable[[], Sequence[float]]        # -> (x, y, yaw)
    set_model_state: Callable[[float, float, float], None]
    send_cmd: Callable[[float, float], None]
    get_contact: Callable[[], bool] = lambda: False
    pause: Callable[[], None] = lambda: None
    unpause: Callable[[], None] = lambda: None
    get_peds: Optional[Callable[[], Sequence[TrackedPed]]] = None
    # camera / laser-image sample -> sensor_maps (gazebo_env.py:258
    # image_last); None -> synthesized from the scan (HardwareEnv.sensor_map)
    get_image: Optional[Callable[[], "np.ndarray"]] = None


class ExternalSimEnv(HardwareEnv):
    """Gym facade over an injected external simulator (single robot)."""

    def __init__(self, cfg, transport: ExternalSimTransport,
                 real_time: bool = True, device="cuda"):
        super().__init__(cfg, send_cmd=transport.send_cmd, device=device)
        self.transport = transport
        self.real_time = real_time
        self.start_pose = tuple(cfg.start_global_pose)
        self.target_pose = tuple(cfg.target_global_pose)
        # min-laser collision threshold (gazebo_env.py:201: the close
        # distance is the configured robot_radius)
        self.close_distance = float(cfg.robot_radius)
        self.is_collision = 0
        self.is_arrive = False
        self.arrival_dist = 1.0          # _is_done: dist < 1 (line 299)

    # -- state pull ---------------------------------------------------------
    def _pull(self) -> None:
        t = self.transport
        self.feed_scan(t.get_scan())
        x, y, yaw = t.get_model_state()[:3]
        self.feed_pose(float(x), float(y), float(yaw))
        if t.get_peds is not None:
            self.feed_peds(t.get_peds())
        if t.get_image is not None:
            self.feed_image(t.get_image())
        self.set_goal(self.target_pose[0], self.target_pose[1])

    def _is_done(self, obs) -> int:
        """dones_info: 5 arrive, 1 collision, 0 running
        (gazebo_env.py:294-308)."""
        vec = obs["vector_states"][0]
        if math.hypot(vec[0], vec[1]) < self.arrival_dist:
            self.is_arrive = True
            return 5
        min_dist = self.close_distance
        if self.laser_norm:
            min_dist /= self.laser_max
        if float(np.min(obs["lasers"])) < min_dist or \
                self.transport.get_contact():
            self.is_collision = 1
            return 1
        return 0

    # -- gym surface --------------------------------------------------------
    def reset(self):
        """Teleport back to the start pose (set_model_state — the reference
        avoids /gazebo/reset_world to keep the world intact,
        gazebo_env.py:106-118) and pull a fresh state."""
        t = self.transport
        t.set_model_state(*self.start_pose)
        self.is_collision = 0
        self.is_arrive = False
        self._last_step_t = None
        self._pull()
        return self.observe()

    def step(self, action):
        if self.real_time:
            now = time.perf_counter()
            if self._last_step_t is not None:
                rem = self.control_hz - (now - self._last_step_t)
                if rem > 0:
                    time.sleep(rem)
            self._last_step_t = time.perf_counter()
        v, w = float(action[0]), float(action[1])
        self.send_cmd(v, w)
        self._pull()
        obs = self.observe()
        done = self._is_done(obs)
        return (obs, np.asarray([0.0]), np.asarray([int(done > 0)]),
                {"dones_info": np.asarray([done]),
                 "arrive": self.is_arrive, "collision": self.is_collision})
