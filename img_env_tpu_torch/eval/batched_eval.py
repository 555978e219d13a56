"""Scene-batched deterministic evaluation: every bank episode is a scene
(torch port of ``img_env_tpu.eval.batched_eval``).

All E bank episodes ride the scene axis of ``parallel.BatchedNavEnv``: one
reset and at most ``max_steps`` batched steps evaluate the whole bank, with
the same episodes as the sequential facade (the ScenarioBank's scenarios
seed the scenes).

THIS IS THE TRUSTED EVALUATOR: its outcome semantics equal the sequential
wrapper stack's (tests/test_torch_eval.py):

  * a robot's label is its FIRST terminal event, with the reference's
    InfoLogWrapper priority — arrive beats a same-step collision
    (base.py:234-254: collisions write dones_info, then arrive overrides);
  * timeout fires after ``cfg.time_max`` steps exactly like
    TimeLimitWrapper (base.py:215-231: ``elapsed > time_max``), so
    ``max_steps`` defaults to ``time_max + 1`` and a terminal event in
    that final step still wins over the timeout label;
  * scenes start fresh, like the sequential facade's ``reset(carry=False)``
    episode loop.

Beyond the dones_info outcomes it reports the reference's crowd-safety
numbers (per-episode min ped clearance; close-to-human rate with the
InfoLogWrapper 1 m threshold, base.py:241-254) and can return a full
``EpisodeRecorder``.  The host reads the collision and arrival codes and
the ped distances every step: that is how it labels and stops early.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from img_env_tpu_torch.constants import (DONE_ARRIVE, DONE_COLL_PED,
                                         DONE_COLL_ROBOT, DONE_COLL_STATIC,
                                         DONE_TIMEOUT)
from img_env_tpu_torch.utils.metrics import batched_dones_summary


def evaluate_batched(
    cfg,
    policy_fn: Optional[Callable] = None,  # (generator, obs) -> [S, N, >=2]
    episodes: int = 50,
    max_steps: Optional[int] = None,       # default: cfg.time_max + 1
    bank=None,                    # ScenarioBank (its first `episodes`)
    seed: int = 0,
    mpc=None,                     # MppiConfig -> evaluate the MPC controller
    force_beep_off: bool = False,  # zero the beep channel (ERVO ablation)
    record: bool = False,          # also return an EpisodeRecorder
    device="cuda",
) -> Tuple[Dict, np.ndarray]:
    """Returns (summary dict, dones_info [episodes, N][, recorder]).

    ``policy_fn(generator, obs)`` gets a ``torch.Generator`` on ``device``
    seeded with ``seed + 1`` (for stochastic policies) and the batch's
    Observation ([S, N, ...] tensors).  With ``mpc``, the scenes are
    planned by one ``MpcController.act_scenes`` call over all S*N robots
    (the JAX package vmaps its act over the scenes)."""
    from img_env_tpu_torch.eval.recorder import ScenarioBank
    from img_env_tpu_torch.parallel.batched_env import BatchedNavEnv

    if bank is None:
        bank = ScenarioBank.generate(seed, episodes)
    if max_steps is None:
        # TimeLimitWrapper fires at elapsed > time_max (base.py:215-231);
        # run that final step so same-step events still beat the timeout
        max_steps = int(cfg.time_max) + 1
    env = BatchedNavEnv(cfg, device, seed=seed)
    dev = env.device
    s = min(int(episodes), len(bank))
    n = cfg.robot.total
    spec = env.core.statics.sampler

    ctl = None
    if mpc is not None:
        from img_env_tpu_torch.mpc.controller import MpcController

        ctl = MpcController(env.core, mpc, seed=seed + 1)
        mpc_states = ctl.init_scenes_state(s)

    t0 = time.perf_counter()
    states, obs = env.reset([bank.sample(e, spec, dev) for e in range(s)])
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    dones_info = np.zeros((s, n), np.int64)
    arrive_step = np.zeros((s, n), np.int64)
    min_clear = np.full((s, n), np.inf)
    close_steps = np.zeros((s, n), np.int64)    # steps with ped < 1 m
    live_steps = np.zeros((s, n), np.int64)     # pre-terminal step count
    rec = None
    if record:
        from img_env_tpu_torch.eval.recorder import (EpisodeRecord,
                                                     EpisodeRecorder)

        rec = EpisodeRecorder(dt=float(cfg.control_hz))
        rec.episodes = [EpisodeRecord() for _ in range(s)]
        goals = states.robots.goal.cpu().numpy()          # [S,N,2]
        for i, e in enumerate(rec.episodes):
            e.goals = goals[i]

    for t in range(max_steps):
        if ctl is not None:
            actions, mpc_states, _ = ctl.act_scenes(states, mpc_states)
        else:
            actions = torch.as_tensor(policy_fn(gen, obs), device=dev,
                                      dtype=torch.float32)
        if actions.shape[-1] < 3:
            actions = torch.cat(
                [actions, actions.new_zeros(actions.shape[:-1] + (1,))], -1)
        if force_beep_off:
            actions = torch.cat([actions[..., :2],
                                 torch.zeros_like(actions[..., 2:3])], -1)
        states, obs, reward, done, info = env.step(states, actions)
        coll = obs.is_collisions.cpu().numpy()
        arr = obs.is_arrives.cpu().numpy()
        pmd = obs.ped_min_dists.cpu().numpy()
        fresh = dones_info == 0
        # InfoLogWrapper priority: collisions label first, arrive overrides
        # (base.py:234-254) — so a same-step arrive+collision is an arrive
        for code, val in ((1, DONE_COLL_STATIC), (2, DONE_COLL_PED),
                          (3, DONE_COLL_ROBOT)):
            dones_info[fresh & (coll == code)] = val
        dones_info[fresh & (arr > 0)] = DONE_ARRIVE
        arrive_step[fresh & (arr > 0)] = t + 1
        live_steps[fresh] += 1
        if np.isfinite(pmd).any():
            min_clear[fresh] = np.minimum(min_clear[fresh], pmd[fresh])
            close_steps[fresh & (pmd < 1.0)] += 1
        if rec is not None:
            poses = states.robots.pose.cpu().numpy()      # [S,N,3]
            acts = actions.cpu().numpy()
            for i, e in enumerate(rec.episodes):
                e.robot_poses.append(poses[i])
                e.robot_vws.append(acts[i, :, :2])
        if (dones_info > 0).all():
            break
    dones_info[dones_info == 0] = DONE_TIMEOUT
    if rec is not None:
        for i, e in enumerate(rec.episodes):
            e.dones_info = dones_info[i]
    wall = time.perf_counter() - t0

    summary = batched_dones_summary(dones_info)
    arrived = dones_info == DONE_ARRIVE
    finite = np.isfinite(min_clear)
    summary.update(
        episodes=s,
        avg_arrive_steps=(float(arrive_step[arrived].mean())
                          if arrived.any() else 0.0),
        wall_s=round(wall, 1),
    )
    if finite.any():
        summary["ped_min_dist_mean"] = float(min_clear[finite].mean())
        summary["close_to_human_rate"] = float(
            close_steps.sum() / max(live_steps.sum(), 1))
    out = (summary, dones_info)
    return out + (rec,) if record else out
