"""Observation assembly (torch port of ``img_env_tpu.env.observe``:
vector states, ped vectors and maps, normalised lasers, goal distances;
img_env.cpp:547-587, yaml_env.py:392-481)."""

from __future__ import annotations

import math

import torch

from navbench.reference.ops import f32, pedmap
from navbench.reference.ops.raster import div_const


def vector_state(pose, goal_xy, goal_yaw, vw_last0, state_dim: int):
    """Goal in the base frame (+yaw / velocities), Agent::get_state
    (agent.cpp:156-184). pose [N,3].  In float32 the goal's base-frame
    coordinates carry the JAX package's CPU bits: glibc's sin/cos of the
    yaws and each row one fused multiply-add on the product with c
    (``c dx + s dy`` -> fma(c, dx, s dy), ``c dy - s dx`` -> fma(c, dy,
    -s dx)), as XLA contracts them.  The relative yaw is the atan2 of
    glibc's sin/cos, taken in float64 and rounded once: XLA calls glibc's
    atan2f, which is not correctly rounded, so that one value can sit an
    ulp from the JAX package's."""
    d = goal_xy - pose[:, :2]
    sin, cos = f32.sin_cos(torch.stack([pose[:, 2], goal_yaw - pose[:, 2]]))
    c, s = cos[0], sin[0]
    rows = f32.fma(c, torch.stack([d[:, 0], d[:, 1]]),
                   s * torch.stack([d[:, 1], -d[:, 0]]))
    bx, by = rows[0], rows[1]
    yaw = torch.atan2(sin[1].double(), cos[1].double()).to(pose.dtype)
    if state_dim == 3:
        return torch.stack([bx, by, yaw], -1)
    if state_dim == 4:
        return torch.stack([bx, by, vw_last0[:, 0], vw_last0[:, 1]], -1)
    if state_dim == 5:
        return torch.stack([bx, by, yaw, vw_last0[:, 0], vw_last0[:, 1]], -1)
    raise ValueError(f"state_dim {state_dim} not in (3, 4, 5)")


def peds_in_base(robot_pose, ped_pos, ped_vel):
    """Ped positions / velocities in each robot's base frame
    (img_env.cpp:568-583): robot_pose [..., N, 3], the peds of the same
    scene [..., M, 2].  Returns (px, py, vx, vy) each [..., N, M].  In
    float32 the robot yaw's sin/cos carry glibc's bits and each row
    ``c x + s y`` / ``c y - s x`` is one fused multiply-add on the product
    with c, as XLA contracts the JAX package's expressions (ops/f32.py), so
    the CPU, the card and the JAX package's CPU build agree bit for bit."""
    s, c = f32.sin_cos(robot_pose[..., 2])
    c, s = c[None, ..., None], s[None, ..., None]
    d = ped_pos[..., None, :, :] - robot_pose[..., :, None, :2]  # [..,N,M,2]
    v = ped_vel[..., None, :, :].expand(d.shape)
    # the four rows in one multiply-add over [4, ..., N, M]
    x = torch.stack([d[..., 0], d[..., 1], v[..., 0], v[..., 1]])
    y = torch.stack([d[..., 1], -d[..., 0], v[..., 1], -v[..., 0]])
    return f32.fma(c, x, s * y).unbind(0)


def ped_vectors_and_map(robot_pose, ped_pos, ped_vel, ped_r, robot_r,
                        max_ped: int, ped_vec_dim: int, image_size: int,
                        ped_image_r: float):
    """Sorted 7-dim ped vectors [N, 1 + ped_vec_dim * max_ped], 3-channel
    ped maps [N, 3, hs, hs] and nearest-ped clearances [N].

    yaml_env.py:392-458: peds sorted by base-frame range^2 (stable, so
    equal ranges keep their index order); each vector block is (px, py,
    vx, vy, r, r + robot_r, dist); the map covers +-3 m at 6/image_size
    (ops/pedmap.py, kernel K4 on the card); ped_min_dist is the nearest
    ped's distance minus (ped_r + robot_r).  A leading scene axis
    (robot_pose [S, N, 3], ped_pos / ped_vel [S, M, 2], robot_r [N]) gives
    [S, N, ...] results, every robot of every scene in one flat pass (one
    K4 launch).
    """
    lead = robot_pose.shape[:-1]
    m = ped_pos.shape[-2]
    px, py, vx, vy = (x.reshape(-1, m) for x in
                      peds_in_base(robot_pose, ped_pos, ped_vel))
    n = px.shape[0]
    if n != robot_r.shape[0]:
        robot_r = robot_r.repeat(n // robot_r.shape[0])
    k = min(m, max_ped)
    head = torch.full((n, 1), float(m), dtype=px.dtype, device=px.device)
    tail = px.new_zeros((n, ped_vec_dim * (max_ped - k)))
    if k > 0:
        rsq = pedmap.range_sq(px, py)
        order = torch.argsort(rsq, dim=1, stable=True)[:, :k]
        tk = lambda x: torch.gather(x, 1, order)
        pxs, pys = tk(px), tk(py)
        rr = ped_r[order]
        dist = f32.sqrt(tk(rsq))
        block = torch.stack([pxs, pys, tk(vx), tk(vy), rr,
                             rr + robot_r[:, None], dist], dim=-1)
        vec = torch.cat([head, block.reshape(n, k * ped_vec_dim), tail], 1)
        ped_min = dist[:, 0] - (rr[:, 0] + robot_r)
    else:
        vec = torch.cat([head, tail], 1)
        ped_min = torch.full((n,), math.inf, dtype=px.dtype,
                             device=px.device)
    ped_map = pedmap.ped_map(px, py, vx, vy, 6.0 / image_size, ped_image_r,
                             image_size)
    unflat = lambda x: x.reshape(lead + x.shape[1:])
    return unflat(vec), unflat(ped_map), unflat(ped_min)


def norm_lasers(hits, laser_max: float, laser_norm: bool):
    return div_const(hits, laser_max) if laser_norm else hits


def goal_distances(vec_states):
    """|goal| in the base frame: in float32 the correctly rounded root of
    fma(x, x, y * y), as XLA contracts the JAX package's sum of squares."""
    x, y = vec_states[:, 0], vec_states[:, 1]
    return f32.sqrt(f32.fma(x, x, y * y))
