"""Reward functions, batched over robots (torch port of
``img_env_tpu.env.rewards``).

``paper_reward`` reproduces SensorsPaperRewardWrapper (envs/wrapper/base.py:
153-195) exactly, including the quirk that the pedestrian-proximity penalty is
*overwritten* (not added) by the -500 collision penalty, and that arrival
checks both the current goal distance and the latched arrive flag.  The JAX
facade runs it op by op, outside any jit (gymapi.py:221-227), so the same
float32 ops in the same order give its bits: no multiply-add is fused.
"""

from __future__ import annotations

import torch

from navbench.reference.constants import (
    ARRIVE_DIST,
    REWARD_COLLISION,
    REWARD_DISTANCE_FACTOR,
    REWARD_PED_FACTOR,
    REWARD_REACH,
    REWARD_STEP,
)


def paper_reward(vec_states, is_collisions, is_arrives, step_ds,
                 ped_min_dists, ped_safety_space: float):
    d = torch.sqrt(vec_states[:, 0] ** 2 + vec_states[:, 1] ** 2)
    proximity = torch.where(
        ped_min_dists <= ped_safety_space,
        REWARD_PED_FACTOR * (ped_safety_space - ped_min_dists), 0.0)
    collided = is_collisions > 0
    collision_r = torch.where(collided, REWARD_COLLISION, proximity)
    reached = (d < ARRIVE_DIST) | (is_arrives > 0)
    reach_r = torch.where(~collided & reached, REWARD_REACH, 0.0)
    moving = ~collided & ~reached
    distance_r = torch.where(moving, step_ds * REWARD_DISTANCE_FACTOR, 0.0)
    step_r = torch.where(moving, REWARD_STEP, 0.0)
    return collision_r + reach_r + distance_r + step_r


def base_reward(is_collisions, is_arrives):
    """ImageEnv.step's raw reward: arrive - collision_code (yaml_env.py:373)."""
    return is_arrives.to(torch.float32) - is_collisions.to(torch.float32)


def compute_dones(is_collisions, is_arrives):
    """yaml_env.py:374-376: clip(clip(coll,-1,1) + arrive, 0, 1)."""
    return torch.clamp(torch.clamp(is_collisions, -1, 1) + is_arrives, 0, 1)
