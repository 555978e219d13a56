"""Crowd-model-independent pedestrian bookkeeping (torch port of
``img_env_tpu.crowd.common``): trajectory waypoint cycling, beep sampling
(img_env.cpp:304-359) and the dataset replay (img_env.cpp:361-386).

Beeps are drawn every step, crowd or not (nav_env.py's ``_crowd_step``):
the beep flags land in ``RobotState.beep``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from img_env_tpu_torch.constants import PED_WAYPOINT_DIST_SQ


def _take(traj, idx):
    """traj [..., M, W, 2] at per-ped slot idx [..., M] -> [..., M, 2]."""
    i = idx[..., None, None]
    return torch.gather(traj, -2, i.expand(i.shape[:-1] + (2,)))[..., 0, :]


def advance_traj_goals(pos, traj, traj_len, traj_idx
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next goals with the reference's index quirk.

    The C++ checks arrival against ``trajectory_[cur_traj_index_]`` without
    the modulo of ``_get_cur_goal`` (img_env.cpp:314-317,
    agent.cpp:839-843): once the raw index reaches len(traj) it never
    advances again and the goal stays ``traj[idx % len]``.

    pos [..., M, 2], traj [..., M, W, 2], traj_len / traj_idx [..., M]
    (any leading scene axes).  Returns (next_goals [..., M, 2],
    new_traj_idx [..., M]).
    """
    len_safe = traj_len.clamp(min=1)
    in_range = traj_idx < traj_len
    check = _take(traj, torch.minimum(traj_idx, traj_len - 1).clamp(min=0))
    d_sq = ((check - pos) ** 2).sum(-1)
    arrived = in_range & (d_sq < PED_WAYPOINT_DIST_SQ)
    new_idx = torch.where(arrived, traj_idx + 1, traj_idx)
    goals = _take(traj, torch.remainder(new_idx, len_safe))
    return goals, new_idx


def sample_beeps(robot_pose, v_y, beep_r: float, ped_ca_p: float,
                 u: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Beep source sampling (img_env.cpp:323-342).

    Per robot: with probability ``ped_ca_p`` the pedestrians respond to the
    robot's beep (v_y > 0).  ``u`` is the [N] uniform draw; when omitted it
    is drawn from ``generator``.  Returns (sources [N,2], radii [N],
    beeping [N] int32).
    """
    n = robot_pose.shape[0]
    if u is None:
        u = torch.rand(n, generator=generator, device=robot_pose.device,
                       dtype=robot_pose.dtype)
    responds = (u < ped_ca_p) & (v_y > 0)
    sources = torch.where(responds[:, None], robot_pose[:, :2],
                          torch.zeros_like(robot_pose[:, :2]))
    radii = torch.where(responds, torch.full_like(u, beep_r),
                        torch.zeros_like(u))
    return sources, radii, responds.to(torch.int32)


def dataset_replay(step, traj, traj_v, traj_len):
    """Dataset scene: pose and velocity at the step index, clamped to each
    ped's series (img_env.cpp:361-386).  traj, traj_v: [..., M, T, 2];
    traj_len [..., M]; step: int, [] or one per scene [...].  Returns
    (pos [..., M, 2], vel [..., M, 2], yaw [..., M])."""
    step = torch.as_tensor(step, device=traj_len.device)
    step = step.reshape(step.shape + (1,) * (traj_len.dim() - step.dim()))
    idx = torch.minimum(step, traj_len - 1).clamp(min=0).long()
    pos, vel = _take(traj, idx), _take(traj_v, idx)
    return pos, vel, torch.atan2(vel[..., 1], vel[..., 0])
