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
24-33, envs/wrapper/*).  The hardware and external-simulator frontends
(``env_type`` 'real_env' and 'gazebo_env') are not ported.
"""

from __future__ import annotations

import os
import time
from typing import Union

import numpy as np
import torch

from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.core.state import map_tree
from img_env_tpu_torch.env.nav_env import NavEnv
from img_env_tpu_torch.env.wrappers import (StackedObs, WrapperStack,
                                            vel_action_map)
from img_env_tpu_torch.utils.metrics import EpisodeMetrics


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


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


def make_env(cfg: Union[str, dict, EnvConfig], seed: int = 0,
             device="cuda", **kw) -> ImgNavEnv:
    """Reference-style factory (envs/__init__.py:24-33) for ``env_type``
    'robot_nav': the simulator with the yaml ``wrapper:`` list composed
    over it, on ``device`` (the card by default).  A path needs PyYAML;
    a dict or an EnvConfig does not."""
    if isinstance(cfg, str):
        cfg = EnvConfig.from_yaml(cfg)
    elif isinstance(cfg, dict):
        cfg = EnvConfig.from_dict(cfg)
    if cfg.env_type in ("real_env", "gazebo_env"):
        raise NotImplementedError(
            f"env_type {cfg.env_type!r} (the hardware and external-simulator "
            f"frontends) is not ported (ROADMAP item 14)")
    return ImgNavEnv(cfg, seed=seed, device=device, **kw)
