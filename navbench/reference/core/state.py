"""World-state containers: the ``img_env_tpu.core.state`` pytrees as
NamedTuples of torch tensors, with the same field names.

One ``WorldState`` holds a single scene (N robots, M peds, O obstacles);
a scene batch (``parallel.BatchedNavEnv``) gives every tensor a leading
[S] axis, as the JAX package's vmapped states do.  The JAX state's
``rng`` key has no twin: the port keeps its randomness in the
environment's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

Tensor = torch.Tensor


class RobotState(NamedTuple):
    """Per-robot dynamic state. Leading dim N."""

    pose: Tensor          # [N,3] x, y, yaw (world)
    goal: Tensor          # [N,2] goal position (world)
    goal_yaw: Tensor      # [N]   yaw recorded at set_goal (agent.cpp:148)
    vw_last0: Tensor      # [N,2] previous limited command (v, w)
    vw_last1: Tensor      # [N,2] command before that
    vel_world: Tensor     # [N,2] world-frame (vx, vy) from last substep
    collision: Tensor     # [N] int32 collision code 0/1/2/3 (latched)
    arrive: Tensor        # [N] bool (latched)
    beep: Tensor          # [N] int32 0/1 — beeped this step


class PedState(NamedTuple):
    """Per-pedestrian dynamic state. Leading dim M (0 on the ported path)."""

    pos: Tensor
    yaw: Tensor
    prev_pos: Tensor
    vel: Tensor
    goal: Tensor
    traj: Tensor
    traj_len: Tensor
    traj_idx: Tensor
    gait_state: Tensor
    gait_residual: Tensor
    leg_offset: Tensor
    sfm_wp_idx: Tensor
    sfm_has_dest: Tensor
    sfm_lastdest: Tensor
    dataset_traj: Tensor
    dataset_vel: Tensor
    dataset_len: Tensor


class CrowdAuxState(NamedTuple):
    robot_vel: Tensor     # [N,2] internal crowd-model velocity of robots


class ObstacleState(NamedTuple):
    """Per-episode randomized obstacles. Leading dim O."""

    pose: Tensor          # [O,3]
    size: Tensor          # [O,4]
    is_circle: Tensor     # [O] bool
    aabb: Tensor          # [O,4] world-frame corners (pax,pay,pbx,pby)
    segs: Optional[NamedTuple] = None   # ORCA split segments (crowd line)


class WorldState(NamedTuple):
    robots: RobotState
    peds: PedState
    crowd_aux: CrowdAuxState
    obstacles: ObstacleState
    obs_map: Tensor       # [H,W] uint8 static+obstacle composed occupancy
    obs_edt: Tensor       # [H,W] float32 Euclidean distance to occupied [m]
    step: Tensor          # [] int32 sim step index within the episode
    prev_goal_dist: Tensor  # [N] distance-to-goal after previous obs
    has_prev_dist: Tensor   # [] bool — step_ds is 0 on the first obs


class Observation(NamedTuple):
    """Batched per-robot observation — mirrors ImageState."""

    vector_states: Tensor      # [N,state_dim]
    sensor_maps: Tensor        # [N,48,48] float (/255)
    is_collisions: Tensor      # [N] int32
    is_arrives: Tensor         # [N] int32
    lasers: Tensor             # [N,range_total]
    ped_vector_states: Tensor  # [N,1+ped_vec_dim*max_ped]
    ped_maps: Tensor           # [N,3,48,48]
    step_ds: Tensor            # [N]
    ped_min_dists: Tensor      # [N]
    angular_maps: Tensor = None   # [N,72]
    hit_points: Tensor = None     # [N,range_total,2]


def map_tree(fn: Callable, *trees):
    """``fn`` over the tensors of NamedTuple trees of one structure (states,
    observations), leaves that are None kept: a scene axis added, indexed,
    or stacked without touching the device."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(map_tree(fn, *parts)
                             for parts in zip(*trees)))
    return fn(*trees)


def stack_trees(trees):
    """NamedTuple trees stacked along a new leading axis."""
    return map_tree(lambda *xs: torch.stack(xs), *trees)
