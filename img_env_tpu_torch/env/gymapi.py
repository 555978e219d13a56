"""Gym-style facade mirroring the reference's user API (torch port of
``img_env_tpu.env.gymapi``).

``make_env(cfg)`` accepts a yaml path, a dict or an EnvConfig and returns
an object with the familiar surface:

    env = make_env(cfg_dict)                 # on the card; device="cpu"
    state = env.reset()                      # ObsStateTmp-style list
    state, rewards, dones, info = env.step(actions)

Internally everything runs through ``NavEnv`` (or ``BatchedNavEnv`` when
``num_scenes > 1``) on the env's device; this facade converts to numpy at
the boundary and implements the stateful conveniences (auto-reset, episode
metrics) that the reference provides via Gym wrappers (envs/__init__.py:
24-33, envs/wrapper/*).  ``env_type`` 'real_env' and 'gazebo_env' give the
hardware and external-simulator frontends, with the same wrapper stack
composed over them (``WrappedFrontend``).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.core.state import Observation, map_tree
from img_env_tpu_torch.env.nav_env import NavEnv
from img_env_tpu_torch.env.wrappers import (StackedObs, WrapperStack,
                                            vel_action_map)
from img_env_tpu_torch.utils.metrics import EpisodeMetrics


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class _FlatBatchedCore:
    """NavEnv-shaped facade over BatchedNavEnv: [S,N,...] <-> [S*N,...]."""

    def __init__(self, batched, scenes: int):
        self._env = batched
        self._s = scenes
        self._n = batched.cfg.robot.total
        self.device = batched.device
        self.statics = batched.core.statics

    def _flat(self, tree):
        s, b = self._s, self._s * self._n
        return map_tree(lambda x: x.reshape((b,) + x.shape[2:])
                        if x.ndim >= 2 and x.shape[0] == s else x, tree)

    def reset(self, samples=None, carry=None):
        """``samples``: the S scenes' layouts (default: S draws from the
        batch's generator).  ``carry`` threads through exactly like the
        single-scene path (vw_last1 / gait phase persist across
        auto-resets)."""
        state, obs = self._env.reset(self._s if samples is None else samples,
                                     carry)
        return state, self._flat(obs)

    def step(self, state, cmds):
        actions = cmds.reshape(self._s, self._n, -1)
        state, obs, reward, done, info = self._env.step(state, actions)
        return (state, self._flat(obs), reward.reshape(-1),
                done.reshape(-1), {k: v.reshape(-1) for k, v in info.items()})


class ImgNavEnv:
    """Stateful environment with the reference's step contract.

    ``cfg.num_scenes > 1`` replaces the reference's one-ROS-node-per-scene
    fan-out (``env_num``, create_launch.py:25-34): S independent scenes step
    together and their robots flatten into a single ``[S*N]`` batch, so the
    whole wrapper surface works unchanged.  Auto-reset (NeverStop) then
    triggers when ALL scenes are down.  ``state`` is the current world
    state; ``last_raw_obs`` the unfiltered Observation on the device.
    """

    def __init__(self, cfg: EnvConfig, seed: int = 0, record: bool = False,
                 device="cuda"):
        self.cfg = cfg
        self.scenes = max(int(cfg.num_scenes), 1)
        if self.scenes > 1:
            from img_env_tpu_torch.parallel.batched_env import BatchedNavEnv

            self.core = _FlatBatchedCore(BatchedNavEnv(cfg, device, seed),
                                         self.scenes)
        else:
            self.core = NavEnv(cfg, device, seed)
        self.device = self.core.device
        self.robot_total = cfg.robot.total * self.scenes
        self.ped_total = cfg.ped_sim.total * self.scenes
        self.stack = WrapperStack(cfg, self.robot_total, self.device)
        self.state = None
        self._ws = None
        self.metrics = EpisodeMetrics(cfg)
        self._obs_filter = self._pick_filter(cfg)
        wrappers = set(cfg.wrapper or ())
        # TimeControlWrapper (base.py:301-311): wall-clock pacing, eval only
        self._pace = "TimeControlWrapper" in wrappers
        self._last_step_t = None
        # BagRecordWrapper analogue: host-side episode recording
        self.recorder = None
        if record or "BagRecordWrapper" in wrappers:
            from img_env_tpu_torch.eval.recorder import EpisodeRecorder

            self.recorder = EpisodeRecorder(dt=float(cfg.control_hz))
        # cfg_type 'bag': fixed-scenario replay (yaml_env.py:126-130,234-244)
        # — every method sees the same episode sequence.  A ScenarioBank npz
        # is loaded if present, otherwise generated (and saved when named).
        self.scenario_bank = None
        self._episode_idx = 0
        if cfg.cfg_type == "bag":
            from img_env_tpu_torch.eval.recorder import ScenarioBank

            name = cfg.init_pose_bag_name
            if name and os.path.exists(name):
                self.scenario_bank = ScenarioBank.load(name)
            else:
                self.scenario_bank = ScenarioBank.generate(
                    seed, max(int(cfg.init_pose_bag_episodes), 1))
                if name:
                    self.scenario_bank.save(name)
        # PedTrajectoryDatasetWrapper surface: config-driven ETH/UCY replay.
        # The csv loads once; every world is prebuilt padded to one common
        # length.  Worlds advance every ``repeated_time_per_env`` episodes
        # and cycle (the reference sys.exit()s after the last world,
        # PedTrajectoryDatasetWrapper.py:49-52).
        self._dataset_worlds = None
        self._dataset_episode = 0
        if cfg.ped_traj_dataset:
            if self.scenes > 1:
                raise ValueError(
                    "ped_traj_dataset replay is single-scene (the reference "
                    "wrapper drives one env; see PedTrajectoryDatasetWrapper)")
            self._dataset_worlds = _dataset_worlds(cfg)

    @staticmethod
    def _pick_filter(cfg: EnvConfig):
        w = set(cfg.wrapper)
        if "ObsLaserStateTmp" in w:
            return "laser"
        if "ObsStateTmp" in w:
            return "image"
        return None

    def _filtered(self, sobs: StackedObs):
        if self._obs_filter == "laser":
            return [_np(sobs.lasers), _np(sobs.vector_states),
                    _np(sobs.raw.ped_maps)]
        if self._obs_filter == "image":
            return [_np(sobs.sensor_maps), _np(sobs.vector_states),
                    _np(sobs.raw.ped_maps)]
        return sobs

    def _bank_samples(self):
        """The next bank episode's layout: one scene, or S scenes drawn in
        order from the episode's generator."""
        bank, e = self.scenario_bank, self._episode_idx
        self._episode_idx += 1
        spec = self.core.statics.sampler
        if self.scenes == 1:
            return bank.sample(e, spec, self.device)
        from img_env_tpu_torch.env.sampler import sample_scenario_retry

        if bank.samples is not None:
            raise ValueError("a bank of explicit layouts holds one scene an "
                             "episode; a scene batch replays a seed bank")
        gen = bank.generator(e)
        return [type(s)(*(x.to(self.device) for x in s)) for s in
                (sample_scenario_retry(spec, gen, "cpu")
                 for _ in range(self.scenes))]

    def reset(self, carry: bool = True, sample=None):
        """``carry``: thread the last state's command history, gait and
        crowd velocities into the new episode.  ``sample``: an injected
        layout (a ``ScenarioSample``, or S of them with scenes); default:
        the next bank episode under ``cfg_type: bag``, else a draw from the
        env's generator."""
        carry_state = self.state if carry and self.state is not None else None
        if sample is None and self.scenario_bank is not None:
            sample = self._bank_samples()
        if self._dataset_worlds is not None:
            per = max(int(self.cfg.repeated_time_per_env), 1)
            wi = (self._dataset_episode // per) % len(self._dataset_worlds)
            self._dataset_episode += 1
            self.state, obs = self.core.reset(
                sample, carry_state, dataset=self._dataset_worlds[wi])
        else:
            self.state, obs = self.core.reset(sample, carry_state)
        self.last_raw_obs = obs
        if self._ws is None:
            self._ws = self.stack.init_state()
        self._ws, sobs = self.stack.on_reset(self._ws, obs)
        if self.recorder is not None:
            self.recorder.start_episode()
        return self._filtered(sobs)

    def step(self, actions):
        if self.stack.use_vel_action:
            dtype = torch.int64 if self.cfg.discrete_action else torch.float32
            cmds, speeds = vel_action_map(
                self.cfg, torch.as_tensor(actions, dtype=dtype,
                                          device=self.device))
        else:
            cmds = torch.as_tensor(actions, dtype=torch.float32,
                                   device=self.device).reshape(
                                       self.robot_total, -1)
            if cmds.shape[-1] < 3:
                cmds = torch.cat([cmds, cmds.new_zeros(
                    (self.robot_total, 3 - cmds.shape[-1]))], -1)
            speeds = cmds[:, :2]
        self.state, obs, reward, done, info = self.core.step(self.state, cmds)
        self.last_raw_obs = obs
        info = dict(info)
        info["speeds"] = speeds
        self._ws, sobs, reward, done, info = self.stack.on_step(
            self._ws, obs, reward, done, info)
        np_info = {k: _np(v) for k, v in info.items()}
        self.metrics.add_step(np_info)
        if self.recorder is not None:
            self.recorder.add_step(self.state, reward=reward, speeds=speeds)
        if self._pace:
            # TimeControlWrapper: enforce >= control_hz wall-clock per step
            now = time.perf_counter()
            if self._last_step_t is not None:
                remain = float(self.cfg.control_hz) - (now - self._last_step_t)
                if remain > 0:
                    time.sleep(remain)
            self._last_step_t = time.perf_counter()

        if self.stack.use_never_stop and bool(np_info["all_down"]):
            self.metrics.end_episode(np_info["dones_info"])
            if self.recorder is not None:
                self.recorder.end_episode(np_info["dones_info"])
            obs_out = self.reset()
        else:
            obs_out = self._filtered(sobs)
        return obs_out, _np(reward), _np(done), np_info


def _dataset_worlds(cfg: EnvConfig):
    """Every configured ETH/UCY world as replay arrays padded to the
    configured ped count and to the longest world."""
    from img_env_tpu_torch.datasets.pedestrians import (
        PedDatasetConfig,
        build_world_arrays,
        load_trajectory_csv,
    )

    table = load_trajectory_csv(cfg.ped_traj_dataset)
    dcfg = PedDatasetConfig(
        swapxy=cfg.ped_dataset_swapxy,
        offset=tuple(cfg.ped_dataset_offset),
        fps=int(cfg.ped_dataset_fps),
        control_hz=float(cfg.control_hz),
        start_t=float(cfg.ped_dataset_start_t),
        max_time=float(cfg.ped_dataset_max_time),
        scale_x=float(cfg.ped_dataset_scale[0]),
        scale_y=float(cfg.ped_dataset_scale[1]),
    )
    spans = [(int(s), int(e)) for s, e in cfg.ped_dataset_worlds]
    tmax = max(build_world_arrays(table, s, e - s + 1, dcfg,
                                  pad_peds=cfg.ped_sim.total)[0].shape[1]
               for s, e in spans)
    return [build_world_arrays(table, s, e - s + 1, dcfg,
                               pad_peds=cfg.ped_sim.total, pad_time=tmax)
            for s, e in spans]


class WrappedFrontend:
    """Wrapper stack composed over a hardware/external frontend.

    The reference applies the yaml ``wrapper:`` list to EVERY env_type
    (envs/__init__.py:30-32), so GazeboEnv/RealEnv get action mapping,
    paper reward, time limit, frame stacking and eval metrics exactly like
    the simulator.  This class lifts the single-robot frontend's numpy
    dict observation into the ``Observation`` the stack consumes, on the
    frontend's device (the reference's GazeboEnv likewise returns a full
    ``ImageState``, gazebo_env.py:251-282).  ``last_raw_obs`` is that
    unfiltered Observation, for policy consumers, as on ``ImgNavEnv``.
    """

    def __init__(self, frontend, cfg: EnvConfig):
        self.env = frontend             # raw frontend stays reachable
        self.cfg = cfg
        self.device = frontend.device
        self.stack = WrapperStack(cfg, 1, self.device)
        self.metrics = EpisodeMetrics(cfg)
        self._ws = None
        self._obs_filter = ImgNavEnv._pick_filter(cfg)
        self._prev_dist: Optional[float] = None

    def _t(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    # gazebo_env.py:251-282: frontends report one robot; lift to [1, ...]
    def _to_observation(self, d: Dict[str, Any], dones_info) -> Observation:
        vec = np.asarray(d["vector_states"], np.float32)
        dist = float(np.hypot(float(vec[0, 0]), float(vec[0, 1])))
        step_d = 0.0 if self._prev_dist is None else self._prev_dist - dist
        self._prev_dist = dist
        pv = np.asarray(d["ped_vector_states"], np.float32)
        # nearest-ped clearance = dist - (r + robot_r) of the closest track
        # (yaml_env.py:455 via NearbyPed; inf when no peds, reset_helper.py:92)
        min_d = float(pv[0, 7] - pv[0, 6]) if pv[0, 0] > 0 else float("inf")
        di = int(np.asarray(dones_info).reshape(-1)[0])
        h, w = self.cfg.image_size
        # sensor_maps: the frontend's image when provided (image_last,
        # real_env.py:139 / gazebo_env.py:258), else synthesized from the
        # scan (the reference's _trans_lidar_log_map alternative) on the
        # device, so image policy checkpoints deploy through this facade.
        if "sensor_maps" in d:
            sm = self._t(d["sensor_maps"]).reshape(1, h, w)
        elif "lasers" in d:
            from img_env_tpu_torch.utils.lidar import trans_lidar_log_map

            # frontends normalize lasers (norm_lasers); the log-polar map
            # wants raw ranges in meters
            scan = np.asarray(d["lasers"], np.float32).reshape(-1)
            if self.cfg.laser_norm:
                scan = scan * np.float32(self.cfg.laser_max)
            sm = trans_lidar_log_map(self._t(scan), length=h).reshape(1, h, w)
        else:
            sm = torch.zeros((1, h, w), device=self.device)
        return Observation(
            vector_states=self._t(vec),
            sensor_maps=sm,
            is_collisions=self._t([1 if di in (1, 2, 3) else 0], torch.int32),
            is_arrives=self._t([1 if di == 5 else 0], torch.int32),
            lasers=self._t(d["lasers"]),
            ped_vector_states=self._t(pv),
            ped_maps=self._t(d["ped_maps"]),
            step_ds=self._t([step_d]),
            ped_min_dists=self._t([min_d]),
        )

    def reset(self):
        d = self.env.reset()
        self._prev_dist = None
        if self._ws is None:
            self._ws = self.stack.init_state()
        obs = self.last_raw_obs = self._to_observation(d, np.zeros(1))
        self._ws, sobs = self.stack.on_reset(self._ws, obs)
        return self._filtered(sobs)

    _filtered = ImgNavEnv._filtered

    def step(self, actions):
        if self.stack.use_vel_action:
            if self.cfg.discrete_action:
                raw = self._t(actions, torch.int64).reshape(-1)
            else:
                raw = self._t(actions).reshape(1, -1)
            cmds, speeds = vel_action_map(self.cfg, raw)
            cmd = _np(cmds).reshape(-1, cmds.shape[-1])[0]
            speeds = speeds.reshape(1, -1)
        else:
            cmd = np.asarray(actions, np.float32).reshape(-1)
            speeds = self._t(cmd[:2])[None]
        d, reward, done, info = self.env.step(cmd)
        info = dict(info)
        dones_info = np.asarray(
            info.get("dones_info", np.zeros(1))).reshape(1)
        obs = self.last_raw_obs = self._to_observation(d, dones_info)
        reward = self._t(np.asarray(reward, np.float32).reshape(1))
        done = self._t(np.asarray(done, np.int32).reshape(1), torch.int32)
        info["dones_info"] = self._t(dones_info.astype(np.int32),
                                     torch.int32)
        info["speeds"] = speeds
        self._ws, sobs, reward, done, info = self.stack.on_step(
            self._ws, obs, reward, done, info)
        np_info = {k: _np(v) for k, v in info.items() if not callable(v)}
        self.metrics.add_step(np_info)
        if self.stack.use_never_stop and bool(np_info["all_down"]):
            self.metrics.end_episode(np_info["dones_info"])
            obs_out = self.reset()
        else:
            obs_out = self._filtered(sobs)
        return obs_out, _np(reward), _np(done), np_info


def make_env(cfg: Union[str, dict, EnvConfig], seed: int = 0,
             device="cuda", **kw):
    """Reference-style factory (envs/__init__.py:24-33): dispatch on
    ``env_type`` — 'robot_nav' -> the simulator, 'real_env' -> the
    hardware facade, 'gazebo_env' -> the external-simulator facade (which
    needs a ``transport=`` ``ExternalSimTransport``) — on ``device`` (the
    card by default).  The yaml ``wrapper:`` list composes over every
    frontend, as in the reference (envs/__init__.py:30-32); pass
    ``wrap=False`` for the bare hardware/external facade.  A path needs
    PyYAML; a dict or an EnvConfig does not."""
    if isinstance(cfg, str):
        cfg = EnvConfig.from_yaml(cfg)
    elif isinstance(cfg, dict):
        cfg = EnvConfig.from_dict(cfg)
    wrap = kw.pop("wrap", True)
    if cfg.env_type == "real_env":
        from img_env_tpu_torch.env.hardware_env import HardwareEnv

        env = HardwareEnv(cfg, device=device, **kw)
        return WrappedFrontend(env, cfg) if wrap and cfg.wrapper else env
    if cfg.env_type == "gazebo_env":
        from img_env_tpu_torch.env.external_env import ExternalSimEnv

        if "transport" not in kw:
            raise ValueError(
                "env_type 'gazebo_env' needs a transport= keyword: an "
                "ExternalSimTransport bundling the simulator callbacks "
                "(scan, model state, cmd, contact — the gazebo_env.py "
                "service surface). A rospy bridge is a few lines host-side.")
        env = ExternalSimEnv(cfg, device=device, **kw)
        return WrappedFrontend(env, cfg) if wrap and cfg.wrapper else env
    return ImgNavEnv(cfg, seed=seed, device=device, **kw)
