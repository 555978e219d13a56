"""Planning cost terms for the sampling MPC (torch port of the parts of
``img_env_tpu.mpc.cost`` the MPPI path runs).

The cost mirrors what the reference's reward punishes (SensorsPaperReward,
envs/wrapper/base.py:153-195) as a smooth field: straight-line goal
progress, static clearance from an EDT lookup (plus analytic distance to
episode obstacle AABBs when no episode EDT exists), clearance to predicted
pedestrians / other robots, and control effort and smoothness.  Tensors are
batched as [N robots, K samples, ...].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from img_env_tpu_torch.ops.raster import div_const


class CostWeights(NamedTuple):
    goal: float = 4.0
    terminal_goal: float = 20.0
    collision: float = 400.0
    clearance: float = 30.0         # hinge weight inside the safety band
    safety_dist: float = 0.45       # robot_radius + margin (static band)
    ped_safety: float = 0.7         # ped_safety_space (base.py:164)
    ped_weight: float = 50.0        # matches the -50*(0.7-d) reward slope
    effort_v: float = 0.1
    effort_w: float = 0.05
    smooth: float = 0.2


class WorldCost(NamedTuple):
    """Static per-episode data the cost closes over."""

    edt: torch.Tensor           # [S,H,W] meters to nearest occupied cell,
                                # one map per scene
    resolution: float
    obs_aabb: torch.Tensor      # [S,O,4] episode obstacle corners (world m)
    obs_valid: torch.Tensor     # [S,O]
    robot_radius: float
    scene: torch.Tensor         # [N] int64 scene of each robot


def pooled_edt(edt, pool: int):
    """min-pool the EDT [S, H, W] once per solve over pool-aligned
    blocks."""
    if pool <= 1:
        return edt
    s, h, w = edt.shape
    hp, wp = h // pool * pool, w // pool * pool
    return edt[:, :hp, :wp].reshape(s, hp // pool, pool, wp // pool,
                                    pool).amin(dim=(2, 4))


def _floor_div(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def local_edt_patch(wc: WorldCost, pose_xy, patch_size: int, pool: int = 1):
    """Per-robot EDT window corners.

    pose_xy [N, 2].  Rollouts stay within ``v_max * H * dt`` of the start,
    so a window of ``patch_size`` fine cells centred on the robot's cell
    holds every lookup of the solve.  Returns (patch_shape (ph, pw) in
    pooled cells, corner [N, 2] int64 in fine cells, pool-aligned).
    """
    h, w = wc.edt.shape[-2:]
    ps_h = min((patch_size + pool - 1) // pool * pool, h // pool * pool)
    ps_w = min((patch_size + pool - 1) // pool * pool, w // pool * pool)
    cell = torch.round(div_const(pose_xy, wc.resolution)).to(torch.int64)
    corner = torch.stack([
        torch.clamp(_floor_div(cell[:, 0] - ps_h // 2, pool) * pool, 0,
                    (h - ps_h) // pool * pool),
        torch.clamp(_floor_div(cell[:, 1] - ps_w // 2, pool) * pool, 0,
                    (w - ps_w) // pool * pool),
    ], dim=-1)
    return (ps_h // pool, ps_w // pool), corner


def static_distance_patch(wc: WorldCost, edt_p, patch_shape, corner, xy,
                          pool: int = 1):
    """Nearest-cell EDT lookup served from each robot's
    pooled window: xy [N, K, 2], corner [N, 2].  The window read is a plain
    index gather into the pooled map — exact (the JAX package's one-hot
    MXU select is exact only up to a bf16 operand pass).  Out-of-map points
    read 0.0; AABB terms join when the cost has them."""
    h, w = wc.edt.shape[-2:]
    ps_h, ps_w = patch_shape
    cells = torch.round(div_const(xy, wc.resolution)).to(torch.int64)
    c0 = corner[:, None, 0]
    c1 = corner[:, None, 1]
    li = torch.clamp(_floor_div(cells[..., 0] - c0, pool), 0, ps_h - 1)
    lj = torch.clamp(_floor_div(cells[..., 1] - c1, pool), 0, ps_w - 1)
    d_map = edt_p[wc.scene[:, None], _floor_div(c0, pool) + li,
                  _floor_div(c1, pool) + lj]
    inb = ((cells[..., 0] >= 0) & (cells[..., 0] < h)
           & (cells[..., 1] >= 0) & (cells[..., 1] < w))
    d_map = torch.where(inb, d_map, torch.zeros_like(d_map))
    if wc.obs_aabb.shape[1] == 0:
        return d_map
    box = wc.obs_aabb[wc.scene][:, None]                      # [N,1,O,4]
    lo = torch.minimum(box[..., 0:2], box[..., 2:4])
    hi = torch.maximum(box[..., 0:2], box[..., 2:4])
    p = xy[..., None, :]
    dx = torch.clamp(torch.maximum(lo - p, p - hi), min=0.0)
    d_box = torch.sqrt((dx ** 2).sum(-1) + 1e-12)
    d_box = torch.where(wc.obs_valid[wc.scene][:, None], d_box,
                        torch.full_like(d_box, float("inf"))).amin(dim=-1)
    return torch.minimum(d_map, d_box)


def ped_clearance_at(xy, pos_t, r):
    """Min distance from xy [N, K, 2] to each robot's avoidance set at this
    step, pos_t [N, M, 2] with radii r [N, M]; +inf for an empty set."""
    if pos_t.shape[1] == 0:
        return torch.full(xy.shape[:-1], float("inf"), dtype=xy.dtype,
                          device=xy.device)
    diff = xy[:, :, None, :] - pos_t[:, None, :, :]
    d = torch.sqrt((diff ** 2).sum(-1)) - r[:, None, :]
    return d.amin(dim=-1)


def goal_distance(xy, goal):
    """Straight-line goal distance: xy [N, K, 2], goal [N, 2]."""
    return torch.sqrt(((goal[:, None, :] - xy) ** 2).sum(-1))


def stage_cost(wc: WorldCost, w8: CostWeights, xy, goal, v, w, prev_v,
               prev_w, avoid_pos_t, avoid_r, local_edt):
    """One horizon step's cost [N, K]; local_edt = (pooled edt, patch
    shape, corner, pool) from ``local_edt_patch``."""
    edt_p, shape, corner, pool = local_edt
    goal_d = goal_distance(xy, goal)
    sd = static_distance_patch(wc, edt_p, shape, corner, xy,
                               pool) - wc.robot_radius
    coll = (sd <= 0.0).to(xy.dtype)
    hinge = torch.clamp(w8.safety_dist - sd, min=0.0)
    pd = ped_clearance_at(xy, avoid_pos_t, avoid_r) - wc.robot_radius
    ped_coll = (pd <= 0.0).to(xy.dtype)
    ped_hinge = torch.clamp(w8.ped_safety - pd, min=0.0)
    return (w8.goal * goal_d
            + w8.collision * (coll + ped_coll)
            + w8.clearance * hinge
            + w8.ped_weight * ped_hinge
            + w8.effort_v * v ** 2 + w8.effort_w * w ** 2
            + w8.smooth * ((v - prev_v) ** 2 + (w - prev_w) ** 2))


def terminal_cost(w8: CostWeights, xy, goal):
    return w8.terminal_goal * goal_distance(xy, goal)
