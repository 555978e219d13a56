"""Pedestrian trajectory prediction for the MPC horizon (torch port of
``img_env_tpu.mpc.prediction``).

The controller predicts each pedestrian's next H positions once per solve
and shares the prediction across all K candidate rollouts:

  * 'cv'   — constant velocity (cheapest, default);
  * 'orca' — roll the batched ORCA solver forward H steps, the preferred
             velocity toward the ped's extrapolated goal (crowd/orca.py),
             against the episode's split segments when it has them;
  * 'sfm'  — roll the batched Social Force Model forward H steps toward a
             far waypoint on the ped's heading (crowd/sfm.py).

The robots' influence is left out (robots are the decision variables).
While tracing is on, each crowd-model step of a head ('orca', 'sfm')
counts ``predict.solves`` +1 and ``predict.agents`` +M; 'cv' counts
nothing.
"""

from __future__ import annotations

import torch

from img_env_tpu_torch.crowd import orca as orca_mod
from img_env_tpu_torch.crowd import sfm as sfm_mod
from img_env_tpu_torch.utils import trace


def predict_cv(pos, vel, horizon: int, dt: float):
    """[H,M,2] constant-velocity extrapolation (M may be 0)."""
    t = (torch.arange(horizon, dtype=pos.dtype, device=pos.device)
         + 1.0)[:, None, None] * dt
    return pos[None] + vel[None] * t


def predict_orca(pos, vel, vmax, horizon: int, orca_cfg, segments=None,
                 goal_lookahead: float = 4.0):
    """[H,M,2] by iterating the batched ORCA step (goals extrapolated
    ``goal_lookahead`` s along the velocity; steps of
    ``orca_cfg.time_step``).  ``segments``: the episode's split segments,
    or None for no obstacles."""
    m = pos.shape[0]
    dev = pos.device
    goals = pos + vel * goal_lookahead
    radius = pos.new_full((m,), orca_cfg.radius)
    valid = torch.ones((m,), dtype=torch.bool, device=dev)
    no_robots = pos.new_zeros((0, 2))
    seg = segments if segments is not None else orca_mod.segments_from_aabbs(
        pos.new_zeros((0, 4)), torch.zeros((0,), dtype=torch.bool,
                                           device=dev))
    traj = []
    for _ in range(horizon):
        pos, vel = orca_mod.orca_step(
            pos, vel, orca_mod.pref_velocity(pos, goals), radius, vmax, valid,
            no_robots, no_robots, valid[:0], orca_cfg, seg)
        traj.append(pos)
    trace.count("predict.solves", horizon)
    trace.count("predict.agents", horizon * m)
    return torch.stack(traj)


def predict_sfm(pos, vel, vmax, horizon: int, dt: float,
                goal_lookahead: float = 4.0):
    """[H,M,2] by iterating the batched SFM (single far waypoint)."""
    m = pos.shape[0]
    dev = pos.device
    goals = pos + vel * goal_lookahead
    wp = sfm_mod.SfmWaypointState(
        wp_xy=torch.stack([goals, goals, goals], dim=1),
        wp_r=(torch.arange(3, device=dev) == 0).to(pos.dtype).expand(m, 3),
        wp_len=torch.full((m,), 2, dtype=torch.int32, device=dev),
        dest_idx=torch.zeros((m,), dtype=torch.int32, device=dev),
        head=torch.full((m,), -1, dtype=torch.int32, device=dev),
        has_dest=torch.ones((m,), dtype=torch.bool, device=dev))
    seg = pos.new_zeros((0, 2))
    seg_valid = torch.zeros((0,), dtype=torch.bool, device=dev)
    valid = torch.ones((m,), dtype=torch.bool, device=dev)
    traj = []
    for _ in range(horizon):
        pos, vel, wp = sfm_mod.sfm_step(pos, vel, vmax, valid, wp, seg, seg,
                                        seg_valid, dt)
        traj.append(pos)
    trace.count("predict.solves", horizon)
    trace.count("predict.agents", horizon * m)
    return torch.stack(traj)


def predict_peds(mode: str, pos, vel, vmax, horizon: int, dt: float,
                 orca_cfg=None, segments=None):
    """Dispatch on the head. Returns [H,M,2] predicted positions.  'orca'
    plans with ``orca_cfg`` (the env's statics); any other head than
    'orca' with an ``orca_cfg`` or 'sfm' plans with 'cv', as the
    reference does."""
    if pos.shape[0] == 0:
        return pos.new_zeros((horizon, 0, 2))
    if mode == "orca" and orca_cfg is not None:
        return predict_orca(pos, vel, vmax, horizon, orca_cfg, segments)
    if mode == "sfm":
        return predict_sfm(pos, vel, vmax, horizon, dt)
    return predict_cv(pos, vel, horizon, dt)
