"""Planning cost terms for the sampling and gradient MPC controllers
(torch port of ``img_env_tpu.mpc.cost``).

The cost mirrors what the reference's reward punishes (SensorsPaperReward,
envs/wrapper/base.py:153-195) as a smooth field: goal progress (straight
line, or a geodesic distance-to-goal field), static clearance from an EDT
lookup (plus analytic distance to episode obstacle AABBs when no episode
EDT exists), clearance to predicted pedestrians / other robots, and control
effort and smoothness.  Tensors are batched as [N robots, K samples, ...];
each robot reads the maps of its scene (``WorldCost.scene``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from navbench.reference.ops.raster import div_const


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
    goal_field: Optional[torch.Tensor] = None   # [N,H,W] each robot's
                                # geodesic m-to-goal (global guidance; None
                                # -> straight-line goal term.  See
                                # geodesic_field.)


def _scene_of(wc: WorldCost, xy):
    """Each point's scene: ``wc.scene`` [N] broadcast over xy [N, ..., 2]."""
    return wc.scene.reshape(wc.scene.shape + (1,) * (xy.dim() - 2))


def _aabb_distance(wc: WorldCost, scene, xy, eps: float):
    """Analytic distance from xy [..., 2] to the nearest valid episode AABB
    of its scene (``scene`` broadcastable to xy[..., 0]); None without
    boxes."""
    if wc.obs_aabb.shape[1] == 0:
        return None
    box = wc.obs_aabb[scene]                                  # [...,O,4]
    lo = torch.minimum(box[..., 0:2], box[..., 2:4])
    hi = torch.maximum(box[..., 0:2], box[..., 2:4])
    p = xy[..., None, :]
    dx = torch.maximum(torch.maximum(lo - p, p - hi), xy.new_zeros(()))
    d_box = torch.sqrt((dx ** 2).sum(-1) + eps)
    return torch.where(wc.obs_valid[scene], d_box,
                       torch.full_like(d_box, float("inf"))).amin(dim=-1)


def static_distance(wc: WorldCost, xy):
    """Distance (m) from points xy [N, ..., 2] to the nearest static /
    episode obstacle: the nearest EDT cell of each robot's scene (0.0 off
    the map) and the AABB terms.

    Map convention: row = x, col = y (ops/raster.world_to_cell)."""
    h, w = wc.edt.shape[-2:]
    scene = _scene_of(wc, xy)
    cells = torch.round(div_const(xy, wc.resolution)).to(torch.int64)
    r = torch.clamp(cells[..., 0], 0, h - 1)
    c = torch.clamp(cells[..., 1], 0, w - 1)
    inb = ((cells[..., 0] >= 0) & (cells[..., 0] < h)
           & (cells[..., 1] >= 0) & (cells[..., 1] < w))
    d_map = wc.edt[scene, r, c]
    d_map = torch.where(inb, d_map, torch.zeros_like(d_map))
    d_box = _aabb_distance(wc, scene, xy, 1e-12)
    return d_map if d_box is None else torch.minimum(d_map, d_box)


def _clip01(x):
    """``jnp.clip(x, 0, 1)``: a max then a min, whose derivative at a tie
    is 1/2 (``torch.clamp`` passes all of it); the bilinear weights of a
    point on a cell line are such ties."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _bilinear(grid, index, xy, resolution: float):
    """Bilinear read of ``grid[index]`` [..., H, W] at xy [..., 2] (cells
    clamped to the map), as the reference's smooth lookups compute it."""
    h, w = grid.shape[-2:]
    gx = div_const(xy[..., 0], resolution)
    gy = div_const(xy[..., 1], resolution)
    x0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, h - 2)
    y0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, w - 2)
    fx = _clip01(gx - x0)
    fy = _clip01(gy - y0)
    return ((1 - fx) * (1 - fy) * grid[index, x0, y0]
            + (1 - fx) * fy * grid[index, x0, y0 + 1]
            + fx * (1 - fy) * grid[index, x0 + 1, y0]
            + fx * fy * grid[index, x0 + 1, y0 + 1])


def static_distance_smooth(wc: WorldCost, xy, scene=None):
    """Bilinear-interpolated EDT + analytic AABB distance: C0, with nonzero
    gradients everywhere — what the derivative-based (iLQR) solver needs;
    the sampling solvers use the nearest-cell ``static_distance``.
    ``scene``: each point's scene, broadcastable to xy[..., 0] (default
    ``wc.scene`` over xy [N, ..., 2])."""
    if scene is None:
        scene = _scene_of(wc, xy)
    d_map = _bilinear(wc.edt, scene, xy, wc.resolution)
    d_box = _aabb_distance(wc, scene, xy, 1e-9)
    return d_map if d_box is None else torch.minimum(d_map, d_box)


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
    d_box = _aabb_distance(wc, wc.scene[:, None], xy, 1e-12)
    return d_map if d_box is None else torch.minimum(d_map, d_box)


def ped_clearance(xy, t_idx, ped_pos, ped_vel, ped_r, dt: float):
    """Min distance to constant-velocity-predicted pedestrians.

    xy: [..., 2] at horizon step t_idx (int tensor broadcastable to
    xy[..., 0]); ped_pos, ped_vel [M, 2], ped_r [M]."""
    if ped_pos.shape[0] == 0:
        return torch.full(xy.shape[:-1], float("inf"), dtype=xy.dtype,
                          device=xy.device)
    t = (t_idx.to(xy.dtype) + 1.0) * dt
    pred = ped_pos[None, ...] + ped_vel[None, ...] * t[..., None, None]
    d = torch.sqrt(((xy[..., None, :] - pred) ** 2).sum(-1)) - ped_r[None, :]
    return d.amin(dim=-1)


def ped_clearance_at(xy, pos_t, r):
    """Min distance from xy [N, K, 2] to each robot's avoidance set at this
    step, pos_t [N, M, 2] with radii r [N, M]; +inf for an empty set."""
    if pos_t.shape[1] == 0:
        return torch.full(xy.shape[:-1], float("inf"), dtype=xy.dtype,
                          device=xy.device)
    diff = xy[:, :, None, :] - pos_t[:, None, :, :]
    d = torch.sqrt((diff ** 2).sum(-1)) - r[:, None, :]
    return d.amin(dim=-1)


def geodesic_field(edt, resolution: float, goal_xy, robot_radius: float,
                   iters: int = 0):
    """Geodesic distance-to-goal fields over the robot-inflated free space:
    goal_xy [..., 2] -> [..., H, W], each over its EDT of edt [..., H, W]
    (or one shared [H, W]).

    Min-plus wavefront on the grid (8-neighbourhood; straight step = res,
    diagonal = res*sqrt2), ``2*(h+w)`` iterations by default (``iters`` >
    0 sets them); free space = ``edt > robot_radius``; unreachable and
    occupied cells saturate at ``big``, above the longest path those
    iterations can extend.  The global guidance of the BARN runs (the
    move_base global plan of the reference's protocol).

    Bit-equal to the reference's nine shifted adds and mins: every step is
    a float add and a min, and rounding is monotone, so min(a+s, b+s) is
    min(a, b)+s bit for bit and a candidate that can never win changes
    nothing.  An iteration takes the 3x3-box and plus-shaped minima of the
    field with separable pools (out-of-map neighbours, ``big`` + step in
    the reference, never win), adds the diagonal and the straight step
    once each, and keeps the least; it runs on the negated field so the
    pools are max pools."""
    h, w = edt.shape[-2:]
    batch = goal_xy.shape[:-1]
    dtype, dev = edt.dtype, edt.device
    free = (edt > robot_radius).reshape(-1, 1, h, w)
    n_it = iters if iters > 0 else 2 * (h + w)
    big = (n_it + 2.0) * resolution * 1.4142135   # > any reachable value
    straight, diag = resolution, resolution * 1.4142135
    cell = torch.round(div_const(goal_xy, resolution)).to(torch.int64)
    gr = torch.clamp(cell[..., 0], 0, h - 1).reshape(-1, 1, 1, 1)
    gc = torch.clamp(cell[..., 1], 0, w - 1).reshape(-1, 1, 1, 1)
    goal = ((torch.arange(h, device=dev)[:, None] == gr)
            & (torch.arange(w, device=dev) == gc))            # [B,1,H,W]
    # negated field: -big off the goal, -0.0 on it (so the result is +0.0)
    base = torch.full(goal.shape, -big, dtype=dtype,
                      device=dev).masked_fill(goal, -0.0)
    keep = free & ~goal
    g = base
    for _ in range(n_it):
        col = F.max_pool2d(g, (3, 1), 1, (1, 0))
        plus = torch.maximum(col, F.max_pool2d(g, (1, 3), 1, (0, 1)))
        box = F.max_pool2d(col, (1, 3), 1, (0, 1))
        nd = torch.maximum(g, torch.maximum(plus - straight, box - diag))
        g = torch.where(keep, nd, base)
    return (0.0 - g).reshape(batch + (h, w))


def goal_distance(wc: WorldCost, xy, goal):
    """Goal-progress distance: xy [N, K, 2], goal [N, 2].  The bilinear
    lookup of each robot's geodesic field when ``wc.goal_field`` is set,
    else straight-line (the classic MPPI goal term)."""
    if wc.goal_field is None:
        return torch.sqrt(((goal[:, None, :] - xy) ** 2).sum(-1))
    robot = torch.arange(xy.shape[0], device=xy.device).reshape(
        (-1,) + (1,) * (xy.dim() - 2))
    return _bilinear(wc.goal_field, robot, xy, wc.resolution)


def stage_cost(wc: WorldCost, w8: CostWeights, xy, goal, v, w, prev_v,
               prev_w, avoid_pos_t, avoid_r, local_edt):
    """One horizon step's cost [N, K]; local_edt = (pooled edt, patch
    shape, corner, pool) from ``local_edt_patch``, or None for the
    full-map lookup ``static_distance`` (same values at pool 1)."""
    goal_d = goal_distance(wc, xy, goal)
    if local_edt is None:
        sd = static_distance(wc, xy) - wc.robot_radius
    else:
        edt_p, shape, corner, pool = local_edt
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


def terminal_cost(wc: WorldCost, w8: CostWeights, xy, goal):
    return w8.terminal_goal * goal_distance(wc, xy, goal)
