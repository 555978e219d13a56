"""Pedestrian trajectory prediction for the MPC horizon (torch port of
``img_env_tpu.mpc.prediction``).

The controller predicts each pedestrian's next H positions once per solve
and shares the prediction across all K candidate rollouts:

  * 'cv'   — constant velocity (cheapest, default);
  * 'sfm'  — roll the batched Social Force Model forward H steps toward a
             far waypoint on the ped's heading (crowd/sfm.py).

The robots' influence is left out (robots are the decision variables).
"""

from __future__ import annotations

import torch

from navbench.reference.crowd import sfm as sfm_mod


def predict_cv(pos, vel, horizon: int, dt: float):
    """[H,M,2] constant-velocity extrapolation (M may be 0)."""
    t = (torch.arange(horizon, dtype=pos.dtype, device=pos.device)
         + 1.0)[:, None, None] * dt
    return pos[None] + vel[None] * t


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
    return torch.stack(traj)


def predict_peds(mode: str, pos, vel, vmax, horizon: int, dt: float):
    """Dispatch on the head. Returns [H,M,2] predicted positions.  Any
    head but 'sfm' plans with 'cv' (the program's 'orca' head is not
    copied: no cell drives it)."""
    if pos.shape[0] == 0:
        return pos.new_zeros((horizon, 0, 2))
    if mode == "sfm":
        return predict_sfm(pos, vel, vmax, horizon, dt)
    return predict_cv(pos, vel, horizon, dt)
