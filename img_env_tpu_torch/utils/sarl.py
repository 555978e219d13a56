"""SARL-style state assembly (torch port of ``img_env_tpu.utils.sarl``, the
batched form of envs/utils/sarl_helper.py:6-36).

Builds per-pedestrian rows [robot 7-tuple || ped ``ped_vec_dim``-tuple] from
the env's vector_states and ped_vector_states.  When a robot sees no peds the
reference substitutes a far-away dummy pedestrian — reproduced here.
"""

from __future__ import annotations

import torch

from img_env_tpu_torch.ops import f32


def batched_sarl_states(vector_states, ped_vectors, robot_radius: float,
                        ped_vec_dim: int = 7, max_ped: int = 10,
                        v_pref: float = 0.6):
    """vector_states: [..., 5] (pgx, pgy, _, v, w); ped_vectors:
    [..., 1+D*max_ped], over any leading axes (the JAX package vmaps one
    robot's function over them).

    Returns ([..., max_ped, 7+D] rows, [..., max_ped] valid mask).  Row j
    is the robot 7-tuple (pgx,pgy,v,w,pgd,v_pref,r) followed by ped j's
    D-vector; with no visible peds, row 0 holds the dummy ped
    (10,10,.5,.5,.2,.2+r,14)."""
    vec = torch.as_tensor(vector_states).to(torch.float32)
    ped = torch.as_tensor(ped_vectors).to(torch.float32)
    lead = vec.shape[:-1]
    pgx, pgy, v, w = vec[..., 0], vec[..., 1], vec[..., -2], vec[..., -1]
    # the jitted, vmapped JAX program does not contract this sum; its
    # float32 root is correctly rounded (F14)
    pgd = f32.sqrt(pgx * pgx + pgy * pgy)
    robot7 = torch.stack([pgx, pgy, v, w, pgd, torch.full_like(pgx, v_pref),
                          torch.full_like(pgx, robot_radius)], -1)
    count = ped[..., 0].to(torch.int32)
    peds = ped[..., 1:].reshape(lead + (max_ped, ped_vec_dim))
    dummy = torch.tensor([10.0, 10.0, 0.5, 0.5, 0.2, 0.2 + robot_radius,
                          14.0], dtype=torch.float32,
                         device=vec.device)[:ped_vec_dim]
    row0 = torch.where((count == 0)[..., None], dummy, peds[..., 0, :])
    peds = torch.cat([row0[..., None, :], peds[..., 1:, :]], -2)
    rows = torch.cat([robot7[..., None, :].expand(lead + (max_ped, 7)),
                      peds], -1)
    valid = (torch.arange(max_ped, device=vec.device)
             < torch.clamp(count, min=1)[..., None])
    return rows, valid


def concat_sarl_states(vector_state, ped_vector, robot_radius: float,
                       ped_vec_dim: int = 7, max_ped: int = 10,
                       v_pref: float = 0.6):
    """One robot's rows ([max_ped, 7+D]) and mask ([max_ped]):
    ``batched_sarl_states`` without leading axes."""
    return batched_sarl_states(vector_state, ped_vector, robot_radius,
                               ped_vec_dim, max_ped, v_pref)
