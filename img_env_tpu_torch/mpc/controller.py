"""MPC controller bound to a NavEnv (torch port of
``img_env_tpu.mpc.controller``, MPPI method).

``act_fn`` builds the per-episode ``WorldCost`` from the live state (the
episode EDT that reset computed over the static map plus sampled
obstacles), predicts the pedestrians over the horizon once per solve
(mpc/prediction.py: 'cv', 'orca' or 'sfm') and runs one K-sample MPPI solve per
robot against the peds and the ``avoid_k`` nearest other robots.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from img_env_tpu_torch.core.state import WorldState
from img_env_tpu_torch.mpc.cost import CostWeights, WorldCost
from img_env_tpu_torch.mpc.edt import edt2d
from img_env_tpu_torch.mpc.mppi import MppiConfig, batched_mppi
from img_env_tpu_torch.mpc.prediction import HEADS, predict_peds

OCCUPIED_THRESH = 250  # grid value < 250 is occupied (agent.cpp:394-401)


class MpcState(NamedTuple):
    nominal: torch.Tensor   # [N,H,2]


class MpcController:
    def __init__(self, env, cfg: Optional[MppiConfig] = None,
                 weights: Optional[CostWeights] = None,
                 method: str = "mppi", ped_prediction: str = "cv",
                 seed: int = 0):
        if method != "mppi":
            raise NotImplementedError(
                f"MPC method {method!r} is not ported (only 'mppi')")
        if ped_prediction not in HEADS:
            raise NotImplementedError(
                f"ped prediction head {ped_prediction!r} is not ported "
                f"(only {HEADS})")
        self.ped_prediction = ped_prediction
        self.env = env
        self.device = env.device
        ranges = env.cfg.continuous_actions
        self.cfg = cfg or MppiConfig(
            v_range=tuple(ranges[0]), w_range=tuple(ranges[1]))
        self.weights = weights or CostWeights(
            ped_safety=float(env.cfg.ped_safety_space))
        st = env.statics
        self.robot_radius = (float(np.max(st.robot_radius))
                             if st.robot_radius.size else 0.17)
        self._robot_r = torch.as_tensor(st.robot_radius, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._static_edt = None

    @property
    def static_edt(self) -> torch.Tensor:
        """Host EDT of the static map.  ``world_cost`` reads it only for a
        state without an episode EDT, and the host transform takes seconds
        on a full-size map, so it is built on first use."""
        if self._static_edt is None:
            st = self.env.statics
            occupied = np.asarray(st.static_map) < OCCUPIED_THRESH
            self._static_edt = torch.as_tensor(
                edt2d(occupied, st.resolution), dtype=torch.float32,
                device=self.device)
        return self._static_edt

    def init_state(self) -> MpcState:
        n = self.env.cfg.robot.total
        return MpcState(nominal=torch.zeros((n, self.cfg.horizon, 2),
                                            device=self.device))

    def world_cost(self, state: WorldState) -> WorldCost:
        """Episode clearance field from ``state.obs_edt``; a state without
        the episode EDT falls back to the static EDT + AABB terms."""
        res = self.env.statics.resolution
        if state.obs_edt.shape[0] > 1:
            return WorldCost(
                edt=state.obs_edt, resolution=res,
                obs_aabb=torch.zeros((0, 4), device=self.device),
                obs_valid=torch.zeros((0,), dtype=torch.bool,
                                      device=self.device),
                robot_radius=self.robot_radius)
        o = state.obstacles.aabb.shape[0]
        return WorldCost(
            edt=self.static_edt, resolution=res,
            obs_aabb=state.obstacles.aabb,
            obs_valid=torch.ones((o,), dtype=torch.bool, device=self.device),
            robot_radius=self.robot_radius)

    def draw_noise(self, dtype=torch.float32) -> torch.Tensor:
        """[N, K, H, 2] standard normal MPPI perturbations."""
        n = self.env.cfg.robot.total
        return torch.randn((n, self.cfg.samples, self.cfg.horizon, 2),
                           generator=self.generator, device=self.device,
                           dtype=dtype)

    def act_fn(self, state: WorldState, mpc_state: MpcState, noise=None):
        """Plan for all robots.  Returns (actions [N,3], new MpcState,
        costs [N]).  ``noise``: optional [N, K, H, 2] standard normal draws
        (default: drawn from the controller's generator)."""
        env = self.env
        n = env.cfg.robot.total
        pose = state.robots.pose
        if noise is None:
            noise = self.draw_noise(pose.dtype)
        wc = self.world_cost(state)
        st = env.statics
        dt = float(env.cfg.control_hz)
        # one ped prediction per solve, shared by all rollouts
        ped_traj = predict_peds(
            self.ped_prediction, state.peds.pos.to(pose.dtype),
            state.peds.vel.to(pose.dtype),
            env.crowd.max_speed.to(pose.dtype), self.cfg.horizon, dt,
            orca_cfg=st.orca_cfg, segments=state.obstacles.segs)
        ped_r = env.crowd.ped_r.to(pose.dtype)
        # other robots join the avoidance set as constant-velocity tracks
        ts = (torch.arange(1, self.cfg.horizon + 1, dtype=torch.float32,
                           device=pose.device) * dt).to(pose.dtype)[:, None,
                                                                   None]
        robot_traj = pose[None, :, :2] + state.robots.vel_world[None] * ts
        robot_r = self._robot_r.to(pose.dtype)
        acts, nominal, costs = batched_mppi(
            noise, mpc_state.nominal, pose, state.robots.vw_last0,
            state.robots.vw_last1, state.robots.goal, wc,
            st.limiter_v, st.limiter_w, ped_traj, ped_r, self.cfg,
            self.weights, dt, env.cfg.robot_type == "omni",
            robot_traj=robot_traj, robot_r=robot_r)
        actions = torch.cat([acts, acts.new_zeros((n, 1))], dim=-1)
        return actions, MpcState(nominal=nominal), costs

    def act(self, state: WorldState, mpc_state: MpcState, noise=None):
        return self.act_fn(state, mpc_state, noise)
