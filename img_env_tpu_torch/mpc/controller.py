"""MPC controller bound to a NavEnv (torch port of
``img_env_tpu.mpc.controller``).

``act_scenes`` builds the per-episode ``WorldCost`` from the live states of
S scenes (the episode EDTs that reset computed over the static map plus
sampled obstacles), predicts the pedestrians over the horizon once per
solve (mpc/prediction.py: 'cv', 'orca' or 'sfm') and plans every robot of
every scene in one batch against its scene's peds and other robots: with
``method='ilqr'`` one iLQR solve per robot (mpc/ilqr.py), warm-started
from the shifted plan, and with any other method one K-sample MPPI solve
per robot against the ``avoid_k`` nearest other robots of its scene.
``method='cem'`` plans with MPPI, as the reference's controller does
(controller.py:120-136; ROADMAP F23): ``mppi.cem_plan`` is reachable only
as a function.  ``act_fn`` is the one-scene case.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from img_env_tpu_torch.core.state import WorldState, map_tree
from img_env_tpu_torch.mpc.cost import CostWeights, WorldCost
from img_env_tpu_torch.mpc.edt import edt2d
from img_env_tpu_torch.mpc.ilqr import IlqrConfig, batched_ilqr
from img_env_tpu_torch.mpc.mppi import MppiConfig, batched_mppi
from img_env_tpu_torch.mpc.prediction import predict_peds
from img_env_tpu_torch.utils import trace

OCCUPIED_THRESH = 250  # grid value < 250 is occupied (agent.cpp:394-401)


class MpcState(NamedTuple):
    nominal: torch.Tensor   # [N,H,2]


class MpcController:
    def __init__(self, env, cfg: Optional[MppiConfig] = None,
                 weights: Optional[CostWeights] = None,
                 method: str = "mppi", ped_prediction: str = "cv",
                 seed: int = 0):
        self.ped_prediction = ped_prediction
        self.method = method
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

    def draw_noise(self, dtype=torch.float32, scenes: int = 1):
        """[scenes*N, K, H, 2] standard normal MPPI perturbations."""
        n = scenes * self.env.cfg.robot.total
        return torch.randn((n, self.cfg.samples, self.cfg.horizon, 2),
                           generator=self.generator, device=self.device,
                           dtype=dtype)

    def world_cost(self, states: WorldState) -> WorldCost:
        """Clearance field of S scenes (states with a leading [S] axis):
        the episode EDTs ``states.obs_edt`` [S, H, W]; states without the
        episode EDT fall back to the static EDT plus each scene's obstacle
        AABBs."""
        s, n = states.robots.pose.shape[:2]
        dev = states.robots.pose.device
        scene = torch.arange(s, device=dev).repeat_interleave(n)
        res = self.env.statics.resolution
        if states.obs_edt.shape[1] > 1:
            return WorldCost(
                edt=states.obs_edt, resolution=res,
                obs_aabb=torch.zeros((s, 0, 4), device=dev),
                obs_valid=torch.zeros((s, 0), dtype=torch.bool, device=dev),
                robot_radius=self.robot_radius, scene=scene)
        aabb = states.obstacles.aabb
        return WorldCost(
            edt=self.static_edt[None].expand(s, -1, -1), resolution=res,
            obs_aabb=aabb,
            obs_valid=torch.ones(aabb.shape[:2], dtype=torch.bool,
                                 device=dev),
            robot_radius=self.robot_radius, scene=scene)

    def act_fn(self, state: WorldState, mpc_state: MpcState, noise=None):
        """Plan for all robots of one scene: ``act_scenes`` on a scene axis
        of one.  Returns (actions [N,3], new MpcState, costs [N]).
        ``noise``: optional [N, K, H, 2] standard normal draws (default:
        drawn from the controller's generator)."""
        actions, ms, costs = self.act_scenes(
            map_tree(lambda x: x[None], state),
            MpcState(nominal=mpc_state.nominal[None]),
            None if noise is None else noise[None])
        return actions[0], MpcState(nominal=ms.nominal[0]), costs[0]

    def act(self, state: WorldState, mpc_state: MpcState, noise=None):
        return self.act_fn(state, mpc_state, noise)

    def init_scenes_state(self, scenes: int) -> MpcState:
        n = self.env.cfg.robot.total
        return MpcState(nominal=torch.zeros(
            (scenes, n, self.cfg.horizon, 2), device=self.device))

    @trace.spanned("mpc.act")
    def act_scenes(self, states: WorldState, mpc_state: MpcState,
                   noise=None):
        """Plan for S scenes (states with a leading [S] axis, as
        ``parallel.BatchedNavEnv`` holds them; the JAX package vmaps
        ``act_fn`` over scenes, bench.py:462): all S*N robots in ONE
        ``batched_mppi`` (or ``batched_ilqr``) solve, each robot against
        its own scene's clearance field (``world_cost``), predicted peds
        (predicted once per solve, shared by all rollouts) and robots, the
        other robots joining the avoidance set as constant-velocity tracks.
        ``noise``: optional [S, N, K, H, 2] MPPI draws (default: drawn from
        the controller's generator; iLQR draws none).  Returns (actions
        [S, N, 3], MpcState(nominal [S, N, H, 2]), costs [S, N]).  The ped
        prediction runs once for all scenes with the 'cv' head and scene by
        scene with the crowd heads."""
        env = self.env
        r = states.robots
        s, n = r.pose.shape[:2]
        b = s * n
        flat = lambda x: x.reshape((b,) + x.shape[2:])
        pose = flat(r.pose)
        dtype, dev = pose.dtype, pose.device
        st = env.statics
        dt = float(env.cfg.control_hz)
        horizon = self.cfg.horizon
        pos, vel = states.peds.pos.to(dtype), states.peds.vel.to(dtype)
        vmax = env.crowd.max_speed.to(dtype)
        m = pos.shape[1]
        with trace.span("mpc.predict"):
            if self.ped_prediction not in ("orca", "sfm"):
                ped_traj = predict_peds("cv", pos.reshape(-1, 2),
                                        vel.reshape(-1, 2), vmax.repeat(s),
                                        horizon, dt)
                ped_traj = ped_traj.reshape(horizon, s, m, 2).transpose(0, 1)
            else:
                segs = states.obstacles.segs
                ped_traj = torch.stack([predict_peds(
                    self.ped_prediction, pos[k], vel[k], vmax, horizon, dt,
                    orca_cfg=st.orca_cfg,
                    segments=map_tree(lambda x: x[k], segs))
                    for k in range(s)])                       # [S,H,M,2]
        ts = (torch.arange(1, horizon + 1, dtype=torch.float32, device=dev)
              * dt).to(dtype)[:, None, None]
        robot_traj = pose[None, :, :2] + flat(r.vel_world)[None] * ts
        wc = self.world_cost(states)
        ped_r = env.crowd.ped_r.to(dtype)
        robot_r = self._robot_r.to(dtype).repeat(s)
        if self.method == "ilqr":
            icfg = IlqrConfig(horizon=horizon, v_range=self.cfg.v_range,
                              w_range=self.cfg.w_range)
            us, _, costs = batched_ilqr(
                pose, flat(r.goal), flat(mpc_state.nominal), wc, ped_traj,
                ped_r, icfg, self.weights, dt, robot_traj=robot_traj,
                robot_r=robot_r)
            acts = us[:, 0]
            nominal = torch.cat([us[:, 1:], us[:, -1:]], dim=1)
        else:
            noise = (self.draw_noise(dtype, s) if noise is None
                     else flat(noise))
            acts, nominal, costs = batched_mppi(
                noise, flat(mpc_state.nominal), pose, flat(r.vw_last0),
                flat(r.vw_last1), flat(r.goal), wc, st.limiter_v,
                st.limiter_w, ped_traj, ped_r, self.cfg, self.weights, dt,
                env.cfg.robot_type == "omni", robot_traj=robot_traj,
                robot_r=robot_r)
        actions = torch.cat([acts, acts.new_zeros((b, 1))], dim=-1)
        return (actions.reshape(s, n, 3),
                MpcState(nominal=nominal.reshape(s, n, horizon, 2)),
                costs.reshape(s, n))
