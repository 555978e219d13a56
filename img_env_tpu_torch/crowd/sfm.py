"""Batched Social Force Model (torch port of ``img_env_tpu.crowd.sfm``;
pedsim / Moussaid-Helbing).

pedsim's two-phase update (ped_scene.cpp:167-182) as tensor ops: every
force comes from the pre-step state through dense [A, A] pairwise terms
(the quadtree only prunes: the social force cuts off at 64 m^2,
ped_agent.cpp:343), then all agents move at once.

Reference behaviours kept:
  * the waypoint queue, with its first non-consuming destination and r=0
    waypoints that never complete (pedscene.h:39-47 pushes the goal with
    radius 1, then trajectory points with radius 0);
  * robots as waypoint-less agents whose position is overwritten every step
    but whose internal velocity keeps integrating forces (pedscene.h:53-81);
  * obstacles as diagonal segments from the AABB corners (pedscene.h:23-27);
  * v <- 0.5 v + a h clamped to vmax (ped_agent.cpp:564-567), and the
    move-through-obstacle clamp (ped_agent.cpp:519-553), sequential over
    segments.

Every function takes any leading batch shape: agents ``[..., A, ...]``,
segments ``[..., O, 2]``.  ``NavEnv`` steps the crowds of S scenes as one
batch ``[S, A]``, each scene against its own segments; the MPC's 'sfm'
head steps one population ``[A]``.  Per-agent arithmetic and its
reductions (over the 2 coordinates, the other agents of the scene, the O
segments) are the same in either shape, so on the card a batch of scenes
steps each scene bit for bit as a separate call would.  (Torch's CPU
atan2 rounds an element by its place in the tensor's SIMD loop, so there
the two can differ in the last bit.)
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from img_env_tpu_torch.constants import (
    SFM_AGENT_RADIUS,
    SFM_CUTOFF_DIST_SQ,
    SFM_FACTOR_DESIRED,
    SFM_FACTOR_LOOKAHEAD,
    SFM_FACTOR_OBSTACLE,
    SFM_FACTOR_SOCIAL,
    SFM_GAMMA,
    SFM_LAMBDA,
    SFM_N,
    SFM_N_PRIME,
    SFM_NEIGHBORHOOD_RANGE,
    SFM_OBSTACLE_SIGMA,
)


class SfmWaypointState(NamedTuple):
    """Cyclic waypoint queue per agent (pedsim Tagent::desiredForce)."""

    wp_xy: torch.Tensor       # [...,A,W,2]
    wp_r: torch.Tensor        # [...,A,W]
    wp_len: torch.Tensor      # [...,A] int32 (0 for robots)
    dest_idx: torch.Tensor    # [...,A] int32 current destination slot
    head: torch.Tensor        # [...,A] int32 next fetch position
    has_dest: torch.Tensor    # [...,A] bool


def waypoint_init(wp_xy, wp_r, wp_len) -> SfmWaypointState:
    zi = torch.zeros(wp_len.shape, dtype=torch.int32, device=wp_xy.device)
    return SfmWaypointState(wp_xy=wp_xy, wp_r=wp_r, wp_len=wp_len,
                            dest_idx=zi, head=zi, has_dest=wp_len > 0)


def _norm(v):
    return torch.sqrt((v * v).sum(-1))


def _desired_direction(pos, wp: SfmWaypointState
                       ) -> Tuple[torch.Tensor, SfmWaypointState]:
    """desiredForce's waypoint management (ped_agent.cpp:236-306): the unit
    desired direction and the post-step waypoint state."""
    need_fetch = ~wp.has_dest & (wp.wp_len > 0)
    fetched = torch.remainder(wp.head, wp.wp_len.clamp(min=1))
    dest_idx = torch.where(need_fetch, fetched, wp.dest_idx)
    head = torch.where(need_fetch, wp.head + 1, wp.head)
    has_dest = wp.has_dest | need_fetch

    idx = dest_idx.long()[..., None]
    dest = torch.gather(wp.wp_xy, -2,
                        idx[..., None].expand(idx.shape + (2,)))[..., 0, :]
    dest_r = torch.gather(wp.wp_r, -1, idx)[..., 0]
    diff = dest - pos
    dist = _norm(diff)
    dirn = torch.where(((dist > 0) & has_dest)[..., None],
                       diff / dist.clamp(min=1e-30)[..., None],
                       torch.zeros_like(diff))
    reached = has_dest & (dist < dest_r)
    return dirn, wp._replace(dest_idx=dest_idx, head=head,
                             has_dest=has_dest & ~reached)


def _near(diff, valid):
    """Quadtree neighbourhood (square of half-width 20) of distinct valid
    agents: diff [...,A,A,2], valid [...,A] -> [...,A,A]."""
    a = diff.shape[-2]
    eye = torch.eye(a, dtype=torch.bool, device=diff.device)
    return (valid[..., None, :] & valid[..., :, None] & ~eye
            & (diff[..., 0].abs() <= SFM_NEIGHBORHOOD_RANGE)
            & (diff[..., 1].abs() <= SFM_NEIGHBORHOOD_RANGE))


def _social_force(pos, vel, valid):
    """Pairwise Moussaid-Helbing interaction (ped_agent.cpp:316-404)."""
    diff = pos[..., None, :, :] - pos[..., :, None, :]   # [...,A,A,2] o - s
    dist_sq = (diff * diff).sum(-1)
    near = (_near(diff, valid) & (dist_sq <= SFM_CUTOFF_DIST_SQ)
            & (dist_sq > 0))
    dist = torch.sqrt(dist_sq.clamp(min=1e-30))
    diff_dir = diff / dist[..., None]
    vel_diff = vel[..., :, None, :] - vel[..., None, :, :]   # self - other
    ivec = SFM_LAMBDA * vel_diff + diff_dir
    ilen = _norm(ivec)
    idir = ivec / ilen.clamp(min=1e-30)[..., None]
    # angleTo: signed angle from idir to diff_dir
    dot = (idir * diff_dir).sum(-1).clamp(-1.0, 1.0)
    crs = idir[..., 0] * diff_dir[..., 1] - idir[..., 1] * diff_dir[..., 0]
    theta = torch.atan2(crs, dot)
    theta_sign = torch.sign(theta)        # sign(0) == 0
    b = SFM_GAMMA * ilen
    b_safe = b.clamp(min=1e-30)
    f_vel = -torch.exp(-dist / b_safe - (SFM_N_PRIME * b * theta) ** 2)
    f_ang = -theta_sign * torch.exp(-dist / b_safe - (SFM_N * b * theta) ** 2)
    left_normal = torch.stack([-idir[..., 1], idir[..., 0]], -1)
    force = f_vel[..., None] * idir + f_ang[..., None] * left_normal
    return torch.where(near[..., None], force,
                       torch.zeros_like(force)).sum(-2)


def _obstacle_force(pos, seg_a, seg_b, seg_valid):
    """Closest-obstacle repulsion (ped_agent.cpp:411-429); seg_a/seg_b
    [...,O,2] diagonal segment endpoints, seg_valid [...,O]."""
    if seg_a.shape[-2] == 0:
        return torch.zeros_like(pos)
    rel_end = (seg_b - seg_a)[..., None, :, :]         # [...,1,O,2]
    len_sq = (rel_end * rel_end).sum(-1).clamp(min=1e-30)
    a = seg_a[..., None, :, :]
    relp = pos[..., :, None, :] - a                    # [...,A,O,2]
    lam = ((relp * rel_end).sum(-1) / len_sq).clamp(0.0, 1.0)
    closest = a + lam[..., None] * rel_end
    diff = pos[..., :, None, :] - closest
    dsq = (diff * diff).sum(-1)
    dsq = torch.where(seg_valid[..., None, :], dsq,
                      torch.full_like(dsq, math.inf))
    min_idx = dsq.argmin(dim=-1, keepdim=True)         # [...,A,1]
    min_diff = torch.gather(
        diff, -2, min_idx[..., None].expand(min_idx.shape + (2,)))[..., 0, :]
    min_d = torch.sqrt(torch.gather(dsq, -1, min_idx))[..., 0]
    has_obs = torch.isfinite(min_d)
    amount = torch.exp(-(min_d - SFM_AGENT_RADIUS) / SFM_OBSTACLE_SIGMA)
    dirn = min_diff / min_d.clamp(min=1e-30)[..., None]
    return torch.where(has_obs[..., None], amount[..., None] * dirn,
                       torch.zeros_like(dirn))


def _wrap(x):
    pi = math.pi
    return torch.where(x > pi, x - 2 * pi, torch.where(x < -pi, x + 2 * pi, x))


def _lookahead_force(pos, vel, desired_dir, valid):
    """"Look ahead" lane-changing force (ped_agent.cpp:439-480)."""
    dxy = pos[..., None, :, :] - pos[..., :, None, :]      # other - self
    dist_sq = (dxy * dxy).sum(-1)
    near = _near(dxy, valid) & (dist_sq < 400.0)
    e = desired_dir
    at2v = torch.atan2(-e[..., 0], -e[..., 1])             # [...,A]
    at2d = torch.atan2(-dxy[..., 0], -dxy[..., 1])         # [...,A,A]
    at2v2 = torch.atan2(-vel[..., None, :, 0], -vel[..., None, :, 1])
    s = _wrap(at2d - at2v[..., :, None])
    vv = _wrap(at2v[..., :, None] - at2v2)
    opposite = vv.abs() > 2.5
    dec = near & opposite & (s < 0) & (s > -0.3)
    inc = near & opposite & (s > 0) & (s < 0.3)
    count = (inc.to(torch.int32) - dec.to(torch.int32)).sum(-1)
    right = 0.5 * torch.stack([e[..., 1], -e[..., 0]], -1)
    left = 0.5 * torch.stack([-e[..., 1], e[..., 0]], -1)
    return torch.where((count < 0)[..., None], right,
                       torch.where((count > 0)[..., None], left,
                                   torch.zeros_like(e)))


def _move_clamp(pos, step_vec, seg_a, seg_b, seg_valid):
    """Obstacle line-intersection position clamp (ped_agent.cpp:519-553).

    Sequential over segments in order: each hit rewrites the desired
    position, and the next segment tests the rewritten one.  What does not
    depend on the desired position (the offsets from each segment's start,
    the numerator of the segment parameter t) is computed for every
    segment at once, with the same operations."""
    p_des = pos + step_vec
    if seg_a.shape[-2] == 0:
        return p_des
    vn = step_vec / _norm(step_vec).clamp(min=1e-30)[..., None]
    back = vn * 0.1
    one = torch.ones_like(pos[..., 0])
    s2 = seg_b - seg_a                                  # [...,O,2]
    ns2x = -s2[..., 0]
    rel = pos[..., :, None, :] - seg_a[..., None, :, :]   # [...,A,O,2]
    dx, dy = rel[..., 0], rel[..., 1]
    t_num = s2[..., None, :, 0] * dy - s2[..., None, :, 1] * dx
    for k in range(seg_a.shape[-2]):
        s1 = p_des - pos                                # [...,A,2]
        denom = (ns2x[..., k, None] * s1[..., 1]
                 + s1[..., 0] * s2[..., k, None, 1])
        denom_safe = torch.where(denom == 0, one, denom)
        s = (-s1[..., 1] * dx[..., k] + s1[..., 0] * dy[..., k]) / denom_safe
        t = t_num[..., k] / denom_safe
        hit = (seg_valid[..., k, None] & (denom != 0) & (s >= 0) & (s <= 1)
               & (t >= 0) & (t <= 1))
        clamped = pos + t[..., None] * s1 - back
        p_des = torch.where(hit[..., None], clamped, p_des)
    return p_des


def sfm_step(pos, vel, vmax, valid, wp: SfmWaypointState, seg_a, seg_b,
             seg_valid, h: float):
    """One Tscene::moveAgents(h) over all agents (peds + robot mirrors):
    pos, vel [...,A,2]; vmax, valid [...,A] (or [A], shared by the batch);
    seg_a, seg_b [...,O,2]; seg_valid [...,O] (or [O]).  Returns
    (new_pos, new_vel, new_wp_state)."""
    desired_dir, new_wp = _desired_direction(pos, wp)
    desired = desired_dir * vmax[..., None]
    social = _social_force(pos, vel, valid)
    obstacle = _obstacle_force(pos, seg_a, seg_b, seg_valid)
    lookahead = _lookahead_force(pos, vel, desired_dir, valid)
    accel = (SFM_FACTOR_DESIRED * desired + SFM_FACTOR_SOCIAL * social
             + SFM_FACTOR_OBSTACLE * obstacle
             + SFM_FACTOR_LOOKAHEAD * lookahead)

    new_pos = _move_clamp(pos, vel * h, seg_a, seg_b, seg_valid)
    new_vel = 0.5 * vel + accel * h
    speed = _norm(new_vel)[..., None]
    new_vel = torch.where(speed > vmax[..., None],
                          new_vel / speed.clamp(min=1e-30) * vmax[..., None],
                          new_vel)
    new_pos = torch.where(valid[..., None], new_pos, pos)
    new_vel = torch.where(valid[..., None], new_vel, vel)
    return new_pos, new_vel, new_wp
