"""Differential-drive / omnidirectional robot stepping (torch port of
``img_env_tpu.dynamics.kinematics``), batched over robots.

``Agent::cmd`` (agent.cpp:186-283):

  1. speed-limit (v, w) against the two previous commands;
  2. scan 0.05 s substeps of the *Euler* odometry purely to detect mid-step
     arrival (dist-to-goal <= 0.3) — stopping the scan freezes the reported
     world velocity at the arrival substep, like the C++ ``break``;
  3. advance the actual pose with the exact arc (or straight-line) formula
     over the full control step;
  4. re-check arrival at the final pose.
"""

from __future__ import annotations

import torch

from navbench.reference.constants import ARRIVE_DIST, SUBSTEP_DT
from navbench.reference.dynamics.limiter import LimiterParams, limit_command
from navbench.reference.ops import f32


def _substep_arrival(pose, goal, v, w, v_y, n_substeps: int, omni: bool):
    """Euler substep scan for mid-step arrival (agent.cpp:200-219, 240-255).
    pose [N, 3], goal [N, 2]; returns (vel_world [N, 2], arrived [N]).

    In float32 the bits are the JAX package's CPU build's: glibc's sin/cos
    of each substep angle, and each position row and the squared distance
    contracted into one fused multiply-add, as XLA compiles the scan body
    (ops/f32.py): x' = fma(v dt, c, x) (omni: fma(-v_y dt, s, that)), and
    d^2 = fma(dx, dx, dy * dy).  The angle sum th + w dt is not contracted.
    The C++ ``break`` only freezes values that are never read again, so
    every substep angle is formed first and all go through one sin/cos."""
    th = [pose[:, 2]]
    for _ in range(n_substeps - 1):
        th.append(th[-1] + w * SUBSTEP_DT)
    sin, cos = f32.sin_cos(torch.stack(th))                   # [K, N]
    xy = pose[:, :2].t()                                      # [2, N]
    vd = v * SUBSTEP_DT
    vyd = v_y * SUBSTEP_DT
    vel = torch.zeros_like(xy)
    arrived = torch.zeros_like(v, dtype=torch.bool)
    for k in range(n_substeps):
        c, s = cos[k], sin[k]
        nxy = f32.fma(vd, torch.stack([c, s]), xy)
        if omni:
            nxy = f32.fma(vyd, torch.stack([-s, c]), nxy)
            nvel = vel          # the omni branch never updates vx/vy
        else:
            nvel = v * torch.stack([c, s])   # theta before the update
        dxy = nxy - goal.t()
        d = f32.sqrt(f32.fma(dxy[0], dxy[0], dxy[1] * dxy[1]))
        keep = ~arrived
        xy = torch.where(keep, nxy, xy)
        vel = torch.where(keep, nvel, vel)
        arrived = arrived | (d <= ARRIVE_DIST)
    return vel.t(), arrived


def _exact_pose_update(pose, v, w, v_y, dt: float, omni: bool,
                       fused_yaw: bool = True, xla_bits: bool = True):
    """Closed-form arc update (agent.cpp:220-236, 256-273); pose [..., 3].

    With ``xla_bits`` (the env's step), float32 results carry the JAX
    package's CPU bits: each arc row two nested fused multiply-adds
    (x - vw s + vw sa -> fma(vw, sa, fma(-vw, s, x))), glibc's sin/cos of
    both angles in one call, and the new angle th + w dt as one fused
    multiply-add where ``fused_yaw`` (see ``batched_robot_cmd``), else
    rounded twice.  Without, plain torch arithmetic: the MPPI rollouts,
    which are held to a tolerance, take it at a fraction of the device
    operations."""
    th = pose[..., 2]
    xy = pose[..., :2].movedim(-1, 0)                         # [2, ...]
    w_safe = torch.where(w == 0, torch.ones_like(w), w)
    vw = v / w_safe
    vd = v * dt
    if not xla_bits:
        nth = th + w * dt
        c, s = torch.cos(th), torch.sin(th)
        ca, sa = torch.cos(nth), torch.sin(nth)
        x, y = pose[..., 0], pose[..., 1]
        straight = torch.stack([x + vd * c, y + vd * s])
        arc = torch.stack([x - vw * s + vw * sa, y + vw * c - vw * ca])
        if omni:
            vyd, vyw = v_y * dt, v_y / w_safe
            straight = straight + torch.stack([-vyd * s, vyd * c])
            arc = torch.stack([arc[0] - vyw * c + vyw * ca,
                               arc[1] - vyw * s + vyw * sa])
    else:
        nth = (f32.fma(w, torch.full_like(w, dt), th) if fused_yaw
               else th + w * dt)
        sin, cos = f32.sin_cos(torch.stack([th, nth]))
        s, sa = sin
        c, ca = cos
        straight = f32.fma(vd, torch.stack([c, s]), xy)
        arc = f32.fma(vw, torch.stack([sa, -ca]),
                      f32.fma(vw, torch.stack([-s, c]), xy))
        if omni:
            vyd = v_y * dt
            straight = f32.fma(vyd, torch.stack([-s, c]), straight)
            vyw = v_y / w_safe
            arc = f32.fma(vyw, torch.stack([ca, sa]),
                          f32.fma(vyw, torch.stack([-c, -s]), arc))
    # straight-line branch when w == 0 exactly, as in the reference
    xy = torch.where(w == 0, straight, arc)
    return torch.stack([xy[0], xy[1], nth], dim=-1)


def batched_robot_cmd(poses, goals, vw_last0, vw_last1, vel_world_prev,
                      v, w, v_y, alive,
                      limiter_v: LimiterParams, limiter_w: LimiterParams,
                      dt: float, n_substeps: int, ktype: str = "diff"):
    """All robots at once, with an alive mask.

    Dead robots (alive=False) are frozen in place and keep their previous
    command history *and* world velocity (the reference skips ``cmd`` for
    dead robots but still forwards the stale vx/vy, img_env.cpp:389-418).
    Returns (pose, vw_last0, vw_last1, vel_world, arrive).

    In float32 the result has the bits of the JAX package's step on the
    CPU.  Whether XLA fuses the new yaw's th + w dt depends on what made
    w: the step masks the commands by ``alive`` first, and an acceleration
    or jerk limit on w leaves the product and the sum in one fused
    multiply-add, while with neither (a velocity clamp at most) XLA moves
    the product ahead of the mask's select and clamp, and the sum is
    rounded apart.
    """
    omni = ktype == "omni"
    fused_yaw = limiter_w.has_acceleration or limiter_w.has_jerk
    v = limit_command(limiter_v, v, vw_last0[:, 0], vw_last1[:, 0], dt)
    w = limit_command(limiter_w, w, vw_last0[:, 1], vw_last1[:, 1], dt)
    vel, arrive_sub = _substep_arrival(poses, goals, v, w, v_y, n_substeps,
                                       omni)
    new_pose = _exact_pose_update(poses, v, w, v_y, dt, omni, fused_yaw)
    dxy = new_pose[:, :2] - goals
    d_final = f32.sqrt(f32.fma(dxy[:, 1], dxy[:, 1], dxy[:, 0] * dxy[:, 0]))
    arrive = arrive_sub | (d_final <= ARRIVE_DIST)
    m = alive[:, None]
    return (torch.where(m, new_pose, poses),
            torch.where(m, torch.stack([v, w], dim=-1), vw_last0),
            torch.where(m, vw_last0, vw_last1),
            torch.where(m, vel, vel_world_prev),
            alive & arrive)
