"""The ``rvoscene`` / ``ervoscene`` crowds (ORCA, and ORCA with the beep
evacuation) on the reference's ``NavEnv``, which refuses them: the
program's ORCA branch of the env, frozen.

    env = OrcaNavEnv(cfg, device)   # ped_sim.type 'rvoscene' or 'ervoscene'

What it adds to ``env/nav_env.py``'s ``NavEnv``:

* the ORCA statics: ``OrcaConfig`` (the control period as its time step,
  ``max_obs_segments``) and every ped's ORCA radius (0.5);
* the reset's RVO2 kd-tree split of the sampled rectangles into
  ``ObstacleState.segs`` (``split``; ``crowd/obstacle_split.py``);
* the ORCA branch of the crowd step: the goals cycled, one ORCA step over
  the scene's peds with the robots as neighbours where
  ``relation_ped_robo`` is 1, against the split segments, plus the beep
  evacuation term in ``ervoscene``; then the gait.

Departures from the program's code (``img_env_tpu_torch/env/nav_env.py``):

* the base class builds the statics under the configuration with its crowd
  named ``pedscene``, since it refuses ORCA scenes; the statics depend on
  the crowd model only through that check.  The ORCA configuration and
  radius are held on the env, not in ``EnvStatics`` and ``CrowdTables``;
* the crowd steps one scene at a time (the base's ``advance_scenes``),
  where the program batches the goals and the gait over the scenes around
  ORCA's per-scene solve: elementwise work, the same bits on the card;
* no spans and no counters.
"""

from __future__ import annotations

import dataclasses

import torch

from navbench.reference.config import EnvConfig
from navbench.reference.core.state import WorldState
from navbench.reference.crowd import common as crowd_common
from navbench.reference.crowd import gait as gait_mod
from navbench.reference.crowd import orca as orca_mod
from navbench.reference.crowd.obstacle_split import split_segments
from navbench.reference.env.nav_env import NavEnv
from navbench.reference.ops import f32

ORCA_SCENES = ("rvoscene", "ervoscene")


class OrcaNavEnv(NavEnv):
    """The reference ``NavEnv`` with an ORCA crowd."""

    def __init__(self, cfg: EnvConfig, device="cuda", seed: int = 0):
        if cfg.ped_sim.total < 1 or cfg.ped_sim.type not in ORCA_SCENES:
            raise ValueError(f"an ORCA crowd ({', '.join(ORCA_SCENES)}) "
                             f"with peds, not {cfg.ped_sim.type!r}")
        super().__init__(cfg.replace(ped_sim=dataclasses.replace(
            cfg.ped_sim, type="pedscene")), device, seed)
        self.cfg = cfg
        self.scene_type = cfg.ped_sim.type
        self.orca_cfg = orca_mod.OrcaConfig(
            time_step=float(cfg.control_hz),
            max_obs_segments=int(cfg.max_obs_segments))
        self.orca_radius = torch.full((cfg.ped_sim.total,),
                                      self.orca_cfg.radius,
                                      dtype=torch.float32, device=self.device)

    def split(self, aabb):
        """RVO2's kd-tree segment split of one scene's [O, 4] rectangles,
        as the reset builds it (processObs; KdTree.cpp:131-257); None
        where the peds ignore obstacles or there are none."""
        if self.cfg.ped_sim.ignore_obstacle or aabb.shape[0] == 0:
            return None
        segs, _ = split_segments(aabb, torch.ones(
            aabb.shape[0], dtype=torch.bool, device=aabb.device))
        return segs

    def reset_from_sample(self, sc, carry=None, static_map=None):
        state = super().reset_from_sample(sc, carry, static_map)
        obstacles = state.obstacles
        return state._replace(obstacles=obstacles._replace(
            segs=self.split(obstacles.aabb)))

    def _crowd_step(self, state: WorldState, sources, radii):
        """One scene's peds after one ORCA step and the gait; the robot
        mirrors' crowd velocities are left as they are.
        ``sources``/``radii``: this step's beeps ([N,2], [N])."""
        peds = state.peds
        goals, new_idx = crowd_common.advance_traj_goals(
            peds.pos, peds.traj, peds.traj_len, peds.traj_idx)
        evac = self.scene_type == "ervoscene"
        new_pos, new_vel = self._orca_step(
            state, goals, *((sources, radii) if evac else (None, None)))
        ct = self.crowd
        yaw = torch.atan2(new_vel[:, 1], new_vel[:, 0])
        move = f32.sqrt(((new_pos - peds.pos) ** 2).sum(-1))
        gstate, gres, legs = gait_mod.update_gait(
            peds.gait_state, peds.gait_residual, move, ct.rest_left,
            ct.rest_right)
        return peds._replace(
            pos=new_pos, yaw=yaw, prev_pos=peds.pos, vel=new_vel,
            traj_idx=new_idx, gait_state=gstate, gait_residual=gres,
            leg_offset=legs), state.crowd_aux

    def _orca_step(self, state: WorldState, goals, sources, radii):
        """ORCA over one scene's peds, with the robots as neighbours when
        ``relation_ped_robo`` is 1 (their world velocities), against the
        reset's split segments, or the raw rectangle edges when the reset
        built none.  Every ped solves with the ORCA radius (0.5), not its
        body radius."""
        cfg = self.cfg
        ct = self.crowd
        m = cfg.ped_sim.total
        peds, rob = state.peds, state.robots
        seg = state.obstacles.segs
        if seg is None:
            aabb = state.obstacles.aabb
            seg = orca_mod.segments_from_aabbs(aabb, torch.full(
                (aabb.shape[0],), not cfg.ped_sim.ignore_obstacle,
                dtype=torch.bool, device=self.device))
        rel = int(cfg.relation_ped_robo) == 1
        n_nb = cfg.robot.total if rel else 0
        return orca_mod.orca_step(
            peds.pos, peds.vel, orca_mod.pref_velocity(peds.pos, goals),
            self.orca_radius, ct.max_speed, ct.sfm_valid[:m],
            rob.pose[:n_nb, :2], rob.vel_world[:n_nb],
            ct.sfm_valid[m:m + n_nb], self.orca_cfg, seg,
            evac_sources=sources, evac_radii=radii)
