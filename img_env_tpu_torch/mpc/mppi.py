"""Sampling MPC: MPPI and CEM over the exact unicycle dynamics (torch port
of ``img_env_tpu.mpc.mppi``).

Every robot rolls K perturbed action sequences over an H-step horizon with
the same closed-form arc kinematics and speed limiter the sim applies,
scores them with the planning cost (mpc/cost.py) and returns the
information-theoretic MPPI weighting (or the CEM elite refit).  ``vmap``
over robots becomes a leading robot dimension ([N, K, H, 2] tensors) and
``lax.scan`` over the horizon a Python loop.  The Gaussian noise is an
argument: the controller draws it from its ``torch.Generator`` (the JAX
package's threefry draws cannot be reproduced, so the tests hand both
packages the same noise).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from img_env_tpu_torch.dynamics.kinematics import _exact_pose_update
from img_env_tpu_torch.dynamics.limiter import LimiterParams, limit_command
from img_env_tpu_torch.mpc.cost import (
    CostWeights,
    WorldCost,
    geodesic_field,
    local_edt_patch,
    pooled_edt,
    stage_cost,
    terminal_cost,
)
from img_env_tpu_torch.utils import trace


class MppiConfig(NamedTuple):
    horizon: int = 12
    samples: int = 256
    lam: float = 1.0                 # temperature
    sigma_v: float = 0.15
    sigma_w: float = 0.3
    v_range: Tuple[float, float] = (0.0, 0.6)
    w_range: Tuple[float, float] = (-0.9, 0.9)
    elites: int = 32                 # CEM only
    cem_iters: int = 3               # CEM only
    avoid_k: int = 16                # the k CURRENTLY-nearest other robots
                                     # join each planner's clearance set
                                     # (0 = all N-1)
    exact_cost: bool = False         # no k-nearest pruning, no min-pooled
                                     # EDT window (pool 1)
    goal_field: bool = False         # goal term follows a per-robot
                                     # geodesic distance-to-goal field
                                     # (cost.geodesic_field): global
                                     # guidance for maze/cave worlds (BARN)


class PlannerState(NamedTuple):
    nominal: torch.Tensor   # [H,2] current nominal action plan (v,w)


def init_planner(cfg: MppiConfig, device="cuda",
                 dtype=torch.float32) -> PlannerState:
    return PlannerState(nominal=torch.zeros((cfg.horizon, 2), dtype=dtype,
                                            device=device))


def _perturbed(nominal, noise, std_v, std_w, cfg: MppiConfig):
    """Candidates ``nominal + noise * std`` clipped to the action box, per
    channel (Python scalars need no host-to-device copy): nominal
    [..., H, 2] against noise [..., K, H, 2], std_v / std_w scalars or
    [H]."""
    return torch.stack([
        (nominal[..., None, :, 0] + noise[..., 0] * std_v).clamp(
            cfg.v_range[0], cfg.v_range[1]),
        (nominal[..., None, :, 1] + noise[..., 1] * std_w).clamp(
            cfg.w_range[0], cfg.w_range[1])], dim=-1)


def _rollout_costs(actions, pose, vw0, vw1, goal, wc: WorldCost,
                   w8: CostWeights, limiter_v: LimiterParams,
                   limiter_w: LimiterParams, avoid_traj, avoid_r,
                   dt: float, omni: bool, local_edt):
    """actions [N, K, H, 2]; pose [N, 3]; vw0/vw1 [N, 2]; goal [N, 2];
    avoid_traj [N, H, M, 2], avoid_r [N, M]; local_edt from
    ``local_edt_patch``, or None for full-map lookups.  Returns costs
    [N, K]."""
    n, k, h, _ = actions.shape
    pose = pose[:, None].expand(n, k, 3)
    a0 = vw0[:, None].expand(n, k, 2)
    a1 = vw1[:, None].expand(n, k, 2)
    acc = torch.zeros((n, k), dtype=actions.dtype, device=actions.device)
    for t in range(h):
        act = actions[:, :, t]
        v = limit_command(limiter_v, act[..., 0], a0[..., 0], a1[..., 0], dt)
        w = limit_command(limiter_w, act[..., 1], a0[..., 1], a1[..., 1], dt)
        pose = _exact_pose_update(pose, v, w, 0.0, dt, omni,
                                  xla_bits=False)
        acc = acc + stage_cost(wc, w8, pose[..., :2], goal, v, w,
                               a0[..., 0], a0[..., 1], avoid_traj[:, t],
                               avoid_r, local_edt)
        a0, a1 = torch.stack([v, w], dim=-1), a0
    return acc + terminal_cost(wc, w8, pose[..., :2], goal)


def mppi_plan(noise, ps: PlannerState, pose, vw0, vw1, goal,
              wc: WorldCost, limiter_v: LimiterParams,
              limiter_w: LimiterParams, ped_traj, ped_r,
              cfg: MppiConfig, w8: CostWeights = CostWeights(),
              dt: float = 0.4, omni: bool = False, local_edt=None):
    """One MPPI solve for a single robot.  Returns (action [2], new state,
    cost).

    noise [K, H, 2]: standard normal draws; pose [3], vw0/vw1 [2], goal
    [2]; ``wc`` with ``scene`` [1] (the robot's scene); ped_traj [H, M, 2]
    predicted ped positions (mpc/prediction.py heads), ped_r [M];
    local_edt for the robot from ``local_edt_patch`` (default: full-map
    lookups)."""
    cand = _perturbed(ps.nominal, noise, cfg.sigma_v, cfg.sigma_w, cfg)
    costs = _rollout_costs(cand[None], pose[None], vw0[None], vw1[None],
                           goal[None], wc, w8, limiter_v, limiter_w,
                           ped_traj[None], ped_r[None], dt, omni,
                           local_edt)[0]
    beta = costs.amin()
    wts = torch.softmax(-(costs - beta) / cfg.lam, dim=0)
    plan = torch.einsum("k,khd->hd", wts, cand)
    # receding horizon: shift, repeat last
    nominal = torch.cat([plan[1:], plan[-1:]], dim=0)
    return plan[0], PlannerState(nominal=nominal), (wts * costs).sum()


def cem_plan(noise, ps: PlannerState, pose, vw0, vw1, goal,
             wc: WorldCost, limiter_v: LimiterParams,
             limiter_w: LimiterParams, ped_traj, ped_r,
             cfg: MppiConfig, w8: CostWeights = CostWeights(),
             dt: float = 0.4, omni: bool = False):
    """Cross-entropy method with ``cem_iters`` refits of a diagonal
    Gaussian, for a single robot (arguments as ``mppi_plan``'s).  noise
    [cem_iters, K, H, 2]: each refit's standard normal draws.  The elites
    are the ``cfg.elites`` cheapest candidates, the lower index first on
    ties (``jax.lax.top_k``'s order).  Returns (action [2], new state, the
    last refit's mean elite cost)."""
    mean, std_v, std_w = ps.nominal, cfg.sigma_v, cfg.sigma_w
    for it in range(cfg.cem_iters):
        cand = _perturbed(mean, noise[it], std_v, std_w, cfg)
        costs = _rollout_costs(cand[None], pose[None], vw0[None], vw1[None],
                               goal[None], wc, w8, limiter_v, limiter_w,
                               ped_traj[None], ped_r[None], dt, omni,
                               None)[0]
        idx = torch.sort(costs, stable=True).indices[:cfg.elites]
        elite = cand[idx]                                     # [E,H,2]
        mean = elite.mean(0)
        std = elite.std(0, correction=0) + 1e-4
        std_v, std_w = std[:, 0], std[:, 1]
        cost = costs[idx].mean()
    nominal = torch.cat([mean[1:], mean[-1:]], dim=0)
    return mean[0], PlannerState(nominal=nominal), cost


@trace.spanned("mpc.neighbours")
def _scene_neighbours(poses, scene, robot_traj, robot_r, nps: int,
                      avoid_k: int):
    """Each robot's avoidance tracks among the robots of its own scene:
    the k nearest others (every other, where ``avoid_k`` is 0 or at least
    the scene's other robots), as [N, H, k, 2] tracks and [N, k] radii.
    Set members from another scene sit 1e6 m away: the clearance term is a
    min over the set, which they leave as it is."""
    n = poses.shape[0]
    k = nps - 1 if avoid_k <= 0 or avoid_k >= nps - 1 else avoid_k
    if k == 0:
        return (robot_traj.new_zeros((n, robot_traj.shape[0], 0, 2)),
                robot_r.new_zeros((n, 0)))
    diff = poses[:, None, :2] - poses[None, :, :2]
    apart = (scene[:, None] != scene[None, :]) | torch.eye(
        n, dtype=torch.bool, device=poses.device)
    d2 = torch.where(apart, float("inf"), (diff ** 2).sum(-1))
    _, near = torch.topk(-d2, k, dim=1)                       # [N, k]
    far = torch.gather(apart, 1, near)[:, None, :, None]
    others = robot_traj[:, near].permute(1, 0, 2, 3)          # [N, H, k, 2]
    return torch.where(far, 1e6, others), robot_r[near]


@trace.spanned("mpc.solve")
def batched_mppi(noise, ps_nominal, poses, vw0, vw1, goals,
                 wc: WorldCost, limiter_v: LimiterParams,
                 limiter_w: LimiterParams, ped_traj, ped_r,
                 cfg: MppiConfig, w8: CostWeights = CostWeights(),
                 dt: float = 0.4, omni: bool = False,
                 robot_traj=None, robot_r=None):
    """One MPPI solve per robot of S scenes.  Returns (actions [N,2],
    nominal [N,H,2], costs [N]).

    noise: [N, K, H, 2] standard normal draws (scaled by sigma here).
    ``wc.scene`` [N] gives each robot's scene (all zeros for one scene),
    ``wc.edt`` is [S, H, W].
    ped_traj [S, H, M, 2] / ped_r [M]: predicted pedestrian positions;
    each robot reads its scene's.
    robot_traj [H, N, 2] / robot_r [N]: predicted OTHER-robot positions;
    with ``cfg.avoid_k`` each planner scores only the k currently-nearest
    other robots of its scene (the clearance term is a min, which near
    neighbours decide; all-pairs scoring is O(N^2 K H)), else every other
    robot of its scene.
    With ``cfg.goal_field`` each robot's goal term reads its own geodesic
    field over its scene's EDT, recomputed every solve as the reference
    does (mppi.py:209-212; ROADMAP F8).
    """
    n = poses.shape[0]
    cand = _perturbed(ps_nominal, noise, cfg.sigma_v, cfg.sigma_w, cfg)
    if cfg.goal_field:
        wc = wc._replace(goal_field=geodesic_field(
            wc.edt[wc.scene], float(wc.resolution), goals,
            wc.robot_radius))

    avoid_traj = ped_traj[wc.scene]                           # [N, H, M, 2]
    avoid_r = ped_r[None].expand(n, ped_traj.shape[-2])
    if robot_traj is not None:
        others, others_r = _scene_neighbours(
            poses, wc.scene, robot_traj, robot_r, n // wc.edt.shape[0],
            0 if cfg.exact_cost else cfg.avoid_k)
        avoid_traj = torch.cat([avoid_traj, others], dim=2)
        avoid_r = torch.cat([avoid_r, others_r], dim=1)

    # local EDT windows: rollouts reach at most v_max*H*dt from the start
    vmax = max(abs(cfg.v_range[0]), abs(cfg.v_range[1]))
    reach_cells = int(np.ceil(vmax * cfg.horizon * dt
                              / float(wc.resolution))) + 2
    patch_size = (2 * reach_cells + 2 + 7) // 8 * 8
    pool = 1 if cfg.exact_cost else max(1, patch_size // 96)
    with trace.span("mpc.edt"):
        shape, corner = local_edt_patch(wc, poses[:, :2], patch_size, pool)
        local_edt = (pooled_edt(wc.edt, pool), shape, corner, pool)

    with trace.span("mpc.rollout"):
        costs = _rollout_costs(cand, poses, vw0, vw1, goals, wc, w8,
                               limiter_v, limiter_w, avoid_traj, avoid_r, dt,
                               omni, local_edt)
    beta = costs.amin(dim=1, keepdim=True)
    wts = torch.softmax(-(costs - beta) / cfg.lam, dim=1)     # [N, K]
    plan = torch.einsum("nk,nkhd->nhd", wts, cand)
    nominal = torch.cat([plan[:, 1:], plan[:, -1:]], dim=1)
    return plan[:, 0], nominal, (wts * costs).sum(1)
