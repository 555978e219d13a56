"""The MPC controller with the program's 'orca' prediction head, which
``mpc/controller.py`` and ``mpc/prediction.py`` leave out: a frozen copy
of the program's ``predict_orca`` (``img_env_tpu_torch/mpc/prediction.py``)
on the reference's ORCA (``crowd/orca.py``), and of the crowd heads'
branch of its ``act_scenes``.

    ctl = MpcController(env, MppiConfig(...), ped_prediction="orca")

Each scene's peds are rolled forward H ORCA steps of the control period
(``OrcaConfig`` built from the configuration as the program's statics
build it), the preferred velocity toward a goal 4 s along the ped's
velocity, every ped at the ORCA radius and valid, the robots left out (no
neighbours: they are the decision variables), against the state's split
segments, or none where the state holds none.  The act is the reference
controller's: one ``batched_mppi`` solve over every robot of every scene.
Any other head is the reference controller's own.

Departures from the program's code: the program solves its 'orca' and
'sfm' heads in one branch and counts ``predict.*`` while tracing; here
'sfm' stays with the base class, and nothing is counted.
"""

from __future__ import annotations

from typing import Optional

import torch

from navbench.reference.core.state import WorldState, map_tree
from navbench.reference.crowd import orca as orca_mod
from navbench.reference.mpc import controller as base
from navbench.reference.mpc.mppi import MppiConfig, batched_mppi

MpcState = base.MpcState


def predict_orca(pos, vel, vmax, horizon: int, orca_cfg, segments=None,
                 goal_lookahead: float = 4.0):
    """[H,M,2] by iterating the ORCA step (goals extrapolated
    ``goal_lookahead`` s along the velocity; steps of
    ``orca_cfg.time_step``).  ``segments``: the episode's split segments,
    or None for no obstacles."""
    m = pos.shape[0]
    dev = pos.device
    if m == 0:
        return pos.new_zeros((horizon, 0, 2))
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
    return torch.stack(traj)


class MpcController(base.MpcController):
    """The reference controller, with the 'orca' head besides."""

    def __init__(self, env, cfg: Optional[MppiConfig] = None,
                 weights=None, method: str = "mppi",
                 ped_prediction: str = "cv", seed: int = 0):
        super().__init__(env, cfg, weights, method,
                         "cv" if ped_prediction == "orca" else ped_prediction,
                         seed)
        self.ped_prediction = ped_prediction
        self.orca_cfg = orca_mod.OrcaConfig(
            time_step=float(env.cfg.control_hz),
            max_obs_segments=int(env.cfg.max_obs_segments))

    def act_scenes(self, states: WorldState, mpc_state, noise=None):
        """The base's ``act_scenes``, each scene's peds predicted by ORCA
        where the head is 'orca'."""
        if self.ped_prediction != "orca":
            return super().act_scenes(states, mpc_state, noise)
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
        segs = states.obstacles.segs
        ped_traj = torch.stack([predict_orca(
            pos[k], vel[k], vmax, horizon, self.orca_cfg,
            map_tree(lambda x: x[k], segs))
            for k in range(s)])                               # [S,H,M,2]
        ts = (torch.arange(1, horizon + 1, dtype=torch.float32, device=dev)
              * dt).to(dtype)[:, None, None]
        robot_traj = pose[None, :, :2] + flat(r.vel_world)[None] * ts
        wc = self.world_cost(states)
        ped_r = env.crowd.ped_r.to(dtype)
        robot_r = self._robot_r.to(dtype).repeat(s)
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
