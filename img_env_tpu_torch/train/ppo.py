"""PPO over the scene batch (torch port of ``img_env_tpu.train.ppo``):
rollout, NeverStop autoreset, GAE and the clipped update.

The JAX package compiles a whole update into one XLA program.  Here the
update is a host loop over device work:

  * the rollout: T env steps of ``BatchedNavEnv`` with the current
    policy, each a policy forward (no grad), a Gaussian draw, the env step
    and the paper reward; it makes no host sync;
  * the autoreset: the finished mask (every robot down, or the step count
    at ``time_max``) is read on the host once, and only the finished scenes
    are reset (``BatchedNavEnv.reset(samples)``) and written over their old
    state; the JAX package redraws all S scenes and keeps the finished
    ones, which gives the same state per scene, since the flat sensor pass
    is per robot;
  * GAE as a reverse loop over T;
  * epochs x shuffled minibatches of the clipped loss, each gradient taken
    with TF32 off (``full_float32`` around the backward as around the
    forward), clipped and applied by ``tx`` (``train/optim.py``).

Parameters are a dict of tensors in the policy's state-dict order, applied
with ``torch.func.functional_call``, so a train state is a value, as in
the JAX package.  Draws come from an explicit ``torch.Generator``: the
Gaussian noise of each env step, the reset layouts of the finished scenes
and each epoch's permutation.  ``Draws`` injects them instead (the tests
give the JAX package's draws; torch cannot reproduce threefry, F4).
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import torch
from torch.func import functional_call

from img_env_tpu_torch.core.state import Observation, map_tree
from img_env_tpu_torch.env import rewards as rewards_mod
from img_env_tpu_torch.env.sampler import sample_scenario_retry
from img_env_tpu_torch.models.policy import (CrowdNavPolicy, full_float32,
                                             sample_action)
from img_env_tpu_torch.parallel.batched_env import BatchedNavEnv
from img_env_tpu_torch.train import optim

Tensor = torch.Tensor


class PpoConfig(NamedTuple):
    unroll: int = 8             # env steps per update
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    epochs: int = 4             # passes over the rollout per update
    minibatches: int = 4        # shuffled minibatches per epoch
    max_grad_norm: float = 0.5  # global-norm gradient clip
    reward: str = "paper"       # 'paper' (SensorsPaperReward) | 'base'
    reward_scale: float = 1.0   # scales rewards entering GAE/returns only;
                                #   the reported reward_mean is unscaled
    autoreset: bool = True      # NeverStop: re-draw finished scenes between
                                #   rollouts (all robots down or time_max)


class TrainState(NamedTuple):
    params: Dict[str, Tensor]   # the policy's parameters, state-dict order
    opt_state: Any
    step: Tensor                # [] int32


class Draws(NamedTuple):
    """Injected draws for one ``train_step``: ``eps`` [T, S*N, act_dim]
    standard normals (one row per env step), ``reset`` one
    ``ScenarioSample`` per scene (the finished scenes take theirs),
    ``perms`` [epochs, T*S*N] int64 permutations."""

    eps: Tensor
    reset: Sequence
    perms: Tensor


def obs_features(obs: Observation, use_ped: bool):
    """Flatten an [S, N, ...] observation into the policy's [B, ...]
    inputs."""
    sm = obs.sensor_maps
    b = sm.shape[0] * sm.shape[1]
    sm = sm.reshape(b, 1, sm.shape[-2], sm.shape[-1])
    vs = obs.vector_states.reshape(b, -1)
    if use_ped:
        pm = obs.ped_maps.reshape(b, 3, obs.ped_maps.shape[-2],
                                  obs.ped_maps.shape[-1])
        pv = obs.ped_vector_states.reshape(b, -1)
    else:
        pm = pv = None
    return sm, vs, pm, pv


def gae(values: Tensor, rewards: Tensor, dones: Tensor, last_value: Tensor,
        gamma: float, lam: float) -> Tensor:
    """Generalised advantages over [T, B] by a reverse loop over T."""
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    out = [None] * values.shape[0]
    for t in range(values.shape[0] - 1, -1, -1):
        v, r = values[t], rewards[t]
        nonterm = 1.0 - (dones[t] > 0).to(torch.float32)
        delta = r + gamma * v_next * nonterm - v
        adv_next = delta + gamma * lam * nonterm * adv_next
        v_next = v
        out[t] = adv_next
    return torch.stack(out)


def rollout_data(traj, last_value: Tensor, cfg: PpoConfig):
    """The update's samples from a rollout's per-step ``(feats, act, logp,
    value, reward, done)`` and the value after its last step: ``(feats, act,
    logp_old, advs, returns)`` flattened [T, B, ...] -> [T*B, ...] time-major
    (injected permutations index that order), and the unscaled rewards
    [T, B]."""
    feats_t, *rest = zip(*traj)
    act, logp_old, value_old, reward, done = (torch.stack(x) for x in rest)
    advs = gae(value_old, reward * cfg.reward_scale, done, last_value,
               cfg.gamma, cfg.lam)
    returns = advs + value_old
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    feats = tuple(None if feats_t[0][i] is None else
                  torch.cat([f[i] for f in feats_t]) for i in range(4))
    return (feats, flat(act), flat(logp_old), flat(advs),
            flat(returns)), reward


def take(data, idx: Tensor):
    """The minibatch ``idx`` of ``rollout_data``'s samples."""
    feats, *rest = data
    return (tuple(None if f is None else f[idx] for f in feats),
            *(x[idx] for x in rest))


_LOG_2PI = math.log(2 * math.pi)
_ENT_CONST = 0.5 * math.log(2 * math.pi * math.e)


def minibatch_loss(model: CrowdNavPolicy, params: Dict[str, Tensor], mb,
                   cfg: PpoConfig):
    """The clipped PPO loss on one minibatch ``(feats, act, logp_old, advs,
    returns)``; returns (loss, {pg_loss, vf_loss, entropy}).  Advantages
    are normalised by their population std, as ``jnp.std``."""
    feats, act, logp_old, advs, returns = mb
    advs = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
    mean, log_std, value = functional_call(model, params, tuple(feats))
    logp = (-0.5 * ((act - mean) / torch.exp(log_std)) ** 2
            - log_std - 0.5 * _LOG_2PI).sum(-1)
    ent = (log_std + _ENT_CONST).sum(-1)
    ratio = torch.exp(logp - logp_old)
    pg = -torch.minimum(
        ratio * advs,
        torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * advs).mean()
    vf = 0.5 * ((value - returns) ** 2).mean()
    loss = pg + cfg.vf_coef * vf - cfg.ent_coef * ent.mean()
    return loss, {"pg_loss": pg, "vf_loss": vf, "entropy": ent.mean()}


def loss_and_grads(model, params, mb, cfg: PpoConfig):
    """``minibatch_loss`` and its gradient per parameter, TF32 off in the
    forward and the backward, whatever the caller's flags."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with full_float32():
        loss, aux = minibatch_loss(model, p, mb, cfg)
        grads = torch.autograd.grad(loss, list(p.values()))
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            dict(zip(p, grads)))


def make_train_step(env: BatchedNavEnv, model: CrowdNavPolicy,
                    cfg: PpoConfig = PpoConfig(),
                    tx: Optional[optim.GradientTransformation] = None):
    """Returns ``(init_fn(params), train_step(ts, states, obs, generator,
    draws=None, timings=None))``.  ``train_step`` returns ``(ts, states,
    obs, metrics)`` with the metrics as device scalars: loss, pg_loss,
    vf_loss, entropy (means over epochs x minibatches), reward_mean
    (unscaled), arrive_rate and collision_rate (before the autoreset), and
    reset_scenes (how many scenes the autoreset redrew).  ``timings``: a
    dict that receives the host seconds of the rollout, the autoreset and
    the update (the device synchronised at each boundary)."""
    if model.cfg.discrete_actions > 0:
        raise NotImplementedError(
            "PPO trains the Gaussian head only (as the JAX package's loss "
            "reads (mean, log_std, value)); a discrete head is not ported")
    tx = tx or optim.chain(optim.clip_by_global_norm(cfg.max_grad_norm),
                           optim.adam(cfg.lr))
    ecfg = env.cfg
    use_ped = ecfg.ped_sim.total > 0
    # configs may carry a third (v_y / omni) range; the Gaussian head emits
    # act_dim values, so clip only those
    ranges = ecfg.continuous_actions[: ecfg.act_dim]
    dev = env.device
    lo = torch.as_tensor([r[0] for r in ranges], dtype=torch.float32,
                         device=dev)
    hi = torch.as_tensor([r[1] for r in ranges], dtype=torch.float32,
                         device=dev)
    ped_safety = float(ecfg.ped_safety_space)
    time_max = int(ecfg.time_max)
    spec = env.core.statics.sampler

    def init_fn(params) -> TrainState:
        return TrainState(params, tx.init(params),
                          torch.zeros((), dtype=torch.int32, device=dev))

    def dist(params, feats):
        with torch.no_grad():
            return functional_call(model, params, tuple(feats))

    def rollout(params, states, obs, generator, eps):
        """T env steps with training-stack semantics: the paper reward
        (SensorsPaperRewardWrapper), rewards of already-done robots masked
        (MultiRobotCleanWrapper's is_clean).  No host sync."""
        traj: List[tuple] = []
        for t in range(cfg.unroll):
            feats = obs_features(obs, use_ped)
            # store the RAW Gaussian sample for the loss; only the env
            # command is clipped
            act, logp, value = sample_action(
                dist(params, feats), generator,
                None if eps is None else eps[t])
            act_env = torch.clamp(act, lo, hi)
            s, n = obs.vector_states.shape[:2]
            act_sn = act_env.reshape(s, n, act_env.shape[-1])
            actions = torch.cat([act_sn, act_sn.new_zeros((s, n, 1))], -1)
            states, obs, reward, done, info = env.step(states, actions)
            if cfg.reward == "paper":
                d = obs.vector_states.shape[-1]
                reward = rewards_mod.paper_reward(
                    obs.vector_states.reshape(-1, d),
                    obs.is_collisions.reshape(-1),
                    obs.is_arrives.reshape(-1),
                    obs.step_ds.reshape(-1),
                    obs.ped_min_dists.reshape(-1),
                    ped_safety).reshape(reward.shape)
            reward = torch.where(info["alive"], reward,
                                 torch.zeros_like(reward))
            traj.append((feats, act, logp, value,
                         reward.reshape(-1).to(value.dtype),
                         done.reshape(-1)))
        return states, obs, traj

    def autoreset(states, obs, generator, reset_samples):
        """NeverStop between rollouts: the scenes with every robot down or
        past the time limit restart (fresh layouts, no carry).  Reads the
        finished mask on the host.  Returns (states, obs, scenes reset)."""
        r = states.robots
        done_now = (torch.clamp(r.collision, 0, 1)
                    + r.arrive.to(torch.int32)) > 0
        finished = done_now.all(dim=-1) | (states.step >= time_max)
        ids = torch.nonzero(finished.cpu()).flatten().tolist()
        if not ids:
            return states, obs, 0
        if reset_samples is not None:
            samples = [reset_samples[i] for i in ids]
        else:
            samples = [sample_scenario_retry(spec, generator, dev)
                       for _ in ids]
        rstates, robs = env.reset(samples)
        idx = torch.as_tensor(ids, dtype=torch.int64, device=dev)
        put = lambda old, new: old.index_copy(0, idx, new)
        return (map_tree(put, states, rstates), map_tree(put, obs, robs),
                len(ids))

    def update(ts: TrainState, traj, obs, generator, perms):
        last_value = dist(ts.params, obs_features(obs, use_ped))[-1]
        data, reward = rollout_data(traj, last_value, cfg)
        tb = data[1].shape[0]
        n_mb = max(1, min(cfg.minibatches, tb))
        mb_size = tb // n_mb
        params, opt_state = ts.params, ts.opt_state
        ms = []
        for e in range(cfg.epochs):
            perm = (perms[e] if perms is not None else
                    torch.randperm(tb, generator=generator, device=dev))
            idxs = perm[: mb_size * n_mb].reshape(n_mb, mb_size)
            for idx in idxs:
                loss, aux, grads = loss_and_grads(model, params,
                                                  take(data, idx), cfg)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optim.apply_updates(params, updates)
                ms.append(torch.stack([loss, aux["pg_loss"],
                                       aux["vf_loss"], aux["entropy"]]))
        m = torch.stack(ms).mean(0)
        metrics = dict(zip(("loss", "pg_loss", "vf_loss", "entropy"), m))
        metrics["reward_mean"] = reward.mean()
        return TrainState(params, opt_state, ts.step + 1), metrics

    def lap(timings, name=None, t0=0.0):
        """With ``timings``: synchronise, record the seconds since ``t0``
        under ``name``; returns the time."""
        if timings is None:
            return t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        if name is not None:
            timings[name] = now - t0
        return now

    def train_step(ts: TrainState, states, obs, generator: torch.Generator,
                   draws: Optional[Draws] = None,
                   timings: Optional[dict] = None):
        """One PPO update: unroll -> autoreset -> GAE -> epochs x shuffled
        minibatches of clipped updates."""
        t0 = lap(timings)
        states, obs, traj = rollout(ts.params, states, obs, generator,
                                    None if draws is None else draws.eps)
        # episode outcome rates at the end of the unroll, BEFORE scenes
        # re-draw (the learning curve's signal)
        r = states.robots
        ep_stats = {
            "arrive_rate": r.arrive.to(torch.float32).mean(),
            "collision_rate": torch.clamp(r.collision, 0, 1).to(
                torch.float32).mean(),
        }
        t0 = lap(timings, "rollout", t0)
        n_reset = 0
        if cfg.autoreset:
            states, obs, n_reset = autoreset(
                states, obs, generator,
                None if draws is None else draws.reset)
        t0 = lap(timings, "autoreset", t0)
        ts, metrics = update(ts, traj, obs, generator,
                             None if draws is None else draws.perms)
        lap(timings, "update", t0)
        metrics.update(ep_stats)
        metrics["reset_scenes"] = n_reset
        return ts, states, obs, metrics

    # the unroll alone, (params, states, obs, generator, eps) -> (states,
    # obs, traj): a caller can check it for host syncs
    train_step.rollout = rollout
    return init_fn, train_step
