"""Functional wrapper stack (torch port of ``img_env_tpu.env.wrappers``).

Every reference Gym wrapper (envs/wrapper/base.py, filter_states.py) is a
plain function over ``(Observation, reward, done, info, WrapperState)``.
``WrapperStack`` composes them in the reference's order from ``cfg.wrapper``;
the facade (env/gymapi.py) calls it after each env step.

State that the reference keeps on wrapper instances (frame-stack deques,
elapsed-step counters, clean masks) lives in an explicit ``WrapperState`` of
tensors on the env's device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.constants import (
    DONE_ARRIVE,
    DONE_TIMEOUT,
    PED_VEC_AVG,
    PED_VEC_STD,
)
from img_env_tpu_torch.core.state import Observation
from img_env_tpu_torch.env import rewards as rewards_mod

Tensor = torch.Tensor


class WrapperState(NamedTuple):
    elapsed: Tensor        # [N] int32 step counters (TimeLimit)
    is_clean: Tensor       # [N] bool (MultiRobotClean)
    q_images: Tensor       # [N, image_batch, H, W] frame stack
    q_states: Tensor       # [N, state_batch, state_dim]
    q_lasers: Tensor       # [N, laser_batch(>=1), R]


def init_wrapper_state(cfg: EnvConfig, n_robots: int = None,
                       device="cuda") -> WrapperState:
    n = cfg.robot.total if n_robots is None else n_robots
    ib = max(cfg.image_batch, 0)
    sb = max(cfg.state_batch, 0)
    lb = max(cfg.laser_batch, 1) if cfg.laser_batch >= 0 else 0
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return WrapperState(
        elapsed=torch.zeros((n,), dtype=torch.int32, device=device),
        is_clean=torch.ones((n,), dtype=torch.bool, device=device),
        q_images=z(n, ib, cfg.image_size[0], cfg.image_size[1]),
        q_states=z(n, sb, cfg.state_dim),
        q_lasers=z(n, lb, cfg.range_total),
    )


# ---------------------------------------------------------------------------
# Individual wrappers as plain functions
# ---------------------------------------------------------------------------


def vel_action_map(cfg: EnvConfig, raw_actions: Tensor
                   ) -> Tuple[Tensor, Tensor]:
    """VelActionWrapper (base.py:37-66): discrete index lookup or per-dim clip.

    raw_actions: [N] int indices (discrete) or [N, act_dim] floats.
    Returns ([N,3] (v,w,beep) commands, [N,2] speeds for info).
    """
    if cfg.discrete_action:
        if raw_actions.ndim != 1:
            raise ValueError(
                f"discrete_action config expects [N] action indices, got "
                f"shape {tuple(raw_actions.shape)} — pass indices into "
                f"cfg.discrete_actions, not (v, w) pairs")
        table = torch.zeros((len(cfg.discrete_actions), 3),
                            dtype=torch.float32)
        for i, a in enumerate(cfg.discrete_actions):
            table[i, : len(a)] = torch.as_tensor(a, dtype=torch.float32)
        cmds = table.to(raw_actions.device)[raw_actions.long()]
    else:
        cols = [torch.clamp(raw_actions[..., i], *cfg.continuous_actions[i])
                for i in range(raw_actions.shape[-1])]
        while len(cols) < 3:
            cols.append(torch.zeros_like(cols[0]))
        cmds = torch.stack(cols, dim=-1)
    return cmds, cmds[..., :2]


def paper_reward_wrapper(cfg: EnvConfig, obs: Observation, reward):
    return rewards_mod.paper_reward(
        obs.vector_states, obs.is_collisions, obs.is_arrives,
        obs.step_ds, obs.ped_min_dists, float(cfg.ped_safety_space))


def time_limit_wrapper(cfg: EnvConfig, ws: WrapperState, done, dones_info):
    """TimeLimitWrapper (base.py:215-231)."""
    elapsed = ws.elapsed + 1
    over = elapsed > cfg.time_max
    done = torch.where(over, 1, done)
    dones_info = torch.where(over, DONE_TIMEOUT, dones_info)
    return ws._replace(elapsed=elapsed), done, dones_info


def info_log_wrapper(cfg: EnvConfig, obs: Observation, done, info: Dict):
    """InfoLogWrapper (base.py:234-254)."""
    di = info.get("dones_info", torch.zeros_like(obs.is_collisions))
    di = torch.where(obs.is_collisions > 0, obs.is_collisions, di)
    di = torch.where(obs.is_arrives == 1, DONE_ARRIVE, di)
    info = dict(info)
    info["arrive"] = obs.is_arrives
    info["collision"] = obs.is_collisions
    info["dones_info"] = di
    info["all_down"] = (done > 0).sum() == done.shape[0]
    if cfg.ped_sim.total > 0:
        info["bool_get_close_to_human"] = (obs.ped_min_dists < 1).to(
            torch.int32)
    return info


def multi_robot_clean_wrapper(ws: WrapperState, reward, speeds, done,
                              info: Dict):
    """MultiRobotCleanWrapper (base.py:69-93)."""
    info = dict(info)
    info["is_clean"] = ws.is_clean
    reward = torch.where(ws.is_clean, reward, 0.0)
    speeds = torch.where(ws.is_clean[:, None], speeds, 0.0)
    new_clean = torch.where(done > 0, False, ws.is_clean)
    return ws._replace(is_clean=new_clean), reward, speeds, info


def ped_vector_normalize(obs: Observation, cfg: EnvConfig) -> Observation:
    """StatePedVectorWrapper (base.py:19-34): the first ``count`` ped
    vectors become (body - AVG) / STD, a true division (the JAX facade runs
    it outside any jit)."""
    pv = obs.ped_vector_states
    n = pv.shape[0]
    body = pv[:, 1:].reshape(n, cfg.max_ped, cfg.ped_vec_dim)
    count = pv[:, 0].to(torch.int32)
    j = torch.arange(cfg.max_ped, device=pv.device)
    active = j[None, :] < torch.clamp(count, max=cfg.max_ped)[:, None]
    avg = torch.as_tensor(PED_VEC_AVG, device=pv.device)
    std = torch.as_tensor(PED_VEC_STD, device=pv.device)
    body = torch.where(active[..., None], (body - avg) / std, body)
    return obs._replace(ped_vector_states=torch.cat(
        [pv[:, :1], body.reshape(n, -1)], dim=1))


def state_batch_push(cfg: EnvConfig, ws: WrapperState, obs: Observation):
    """StateBatchWrapper (base.py:97-150): rolling frame stacks.

    Returns (new_ws, stacked sensor_maps [N,k,H,W], flattened vector_states
    [N,k*state_dim], stacked lasers [N,k,R]).
    """
    def push(q, x):
        if q.shape[1] == 0:
            return q, x
        q = torch.cat([q[:, 1:], x[:, None].to(q.dtype)], dim=1)
        return q, q

    qi, imgs = push(ws.q_images, obs.sensor_maps)
    qs, vecs = push(ws.q_states, obs.vector_states)
    ql, lasers = push(ws.q_lasers, obs.lasers)
    if ws.q_states.shape[1] > 0:
        vecs = vecs.reshape(vecs.shape[0], -1)
    return ws._replace(q_images=qi, q_states=qs, q_lasers=ql), imgs, vecs, \
        lasers


def state_batch_clear(ws: WrapperState) -> WrapperState:
    return WrapperState(
        elapsed=torch.zeros_like(ws.elapsed),
        is_clean=torch.ones_like(ws.is_clean),
        q_images=torch.zeros_like(ws.q_images),
        q_states=torch.zeros_like(ws.q_states),
        q_lasers=torch.zeros_like(ws.q_lasers),
    )


# ---------------------------------------------------------------------------
# Composed stack
# ---------------------------------------------------------------------------


class StackedObs(NamedTuple):
    """Observation after StateBatch/filter wrappers (reference layout)."""

    sensor_maps: Tensor      # [N,k,H,W]
    vector_states: Tensor    # [N,k*state_dim]
    lasers: Tensor           # [N,k,R]
    raw: Observation


class WrapperStack:
    """Applies the configured wrapper pipeline.

    The canonical test.yaml order is hard-wired: VelAction -> TimeLimit ->
    PaperReward -> InfoLog -> MultiRobotClean -> [StatePedVector] ->
    StateBatch -> NeverStop (auto-reset, in the facade).  Unlisted wrappers
    are skipped.
    """

    def __init__(self, cfg: EnvConfig, n_robots: int = None, device="cuda"):
        self.cfg = cfg
        self.n_robots = cfg.robot.total if n_robots is None else n_robots
        self.device = torch.device(device)
        w = set(cfg.wrapper) if cfg.wrapper else {
            "VelActionWrapper", "TimeLimitWrapper", "SensorsPaperRewardWrapper",
            "InfoLogWrapper", "MultiRobotCleanWrapper", "StateBatchWrapper",
            "NeverStopWrapper",
        }
        self.use_paper_reward = "SensorsPaperRewardWrapper" in w
        self.use_time_limit = "TimeLimitWrapper" in w
        self.use_info_log = "InfoLogWrapper" in w
        self.use_clean = "MultiRobotCleanWrapper" in w
        self.use_ped_norm = "StatePedVectorWrapper" in w
        self.use_batch = "StateBatchWrapper" in w
        self.use_never_stop = "NeverStopWrapper" in w
        self.use_vel_action = "VelActionWrapper" in w

    def init_state(self) -> WrapperState:
        return init_wrapper_state(self.cfg, self.n_robots, self.device)

    def _stack(self, ws: WrapperState, obs: Observation):
        if self.use_ped_norm:
            obs = ped_vector_normalize(obs, self.cfg)
        if self.use_batch:
            ws, imgs, vecs, lasers = state_batch_push(self.cfg, ws, obs)
        else:
            imgs, vecs, lasers = obs.sensor_maps, obs.vector_states, obs.lasers
        return ws, StackedObs(imgs, vecs, lasers, obs)

    def on_reset(self, ws: WrapperState, obs: Observation):
        return self._stack(state_batch_clear(ws), obs)

    def on_step(self, ws: WrapperState, obs: Observation, reward, done, info):
        cfg = self.cfg
        if self.use_paper_reward:
            reward = paper_reward_wrapper(cfg, obs, reward)
        dones_info = info.get("dones_info",
                              torch.zeros_like(obs.is_collisions))
        if self.use_time_limit:
            ws, done, dones_info = time_limit_wrapper(cfg, ws, done,
                                                      dones_info)
        info = dict(info)
        info["dones_info"] = dones_info
        if self.use_info_log:
            info = info_log_wrapper(cfg, obs, done, info)
        speeds = info.get("speeds", torch.zeros(
            (obs.is_collisions.shape[0], 2), device=reward.device))
        if self.use_clean:
            ws, reward, speeds, info = multi_robot_clean_wrapper(
                ws, reward, speeds, done, info)
        info["speeds"] = speeds
        ws, sobs = self._stack(ws, obs)
        return ws, sobs, reward, done, info
