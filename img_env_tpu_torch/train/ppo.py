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

With the env's ``mesh`` (``BatchedNavEnv(mesh=)``) the update is the torch
form of what GSPMD does for the JAX package's sharded train step: each
rank rolls out, resets and runs GAE on its own block of the scenes; each
minibatch is the global index set of one permutation that every rank
draws, each rank takes the samples of its scenes, the advantages are
normalised by the global mean and population std (two ``all_reduce``s),
each rank's loss is its terms' sum over the global minibatch size, and
the summed gradients (one ``all_reduce``) go through the same clip and
Adam on every rank, so the parameters stay equal on every rank.  A model
axis of more than one rank splits the policy's layers
(``parallel/tp.py``).  Every rank draws what the one-process update
draws, in the same order, and keeps its block.

Parameters are a dict of tensors in the policy's state-dict order, applied
with ``torch.func.functional_call``, so a train state is a value, as in
the JAX package.  Draws come from an explicit ``torch.Generator``: the
Gaussian noise of each env step, the reset layouts of the finished scenes
and each epoch's permutation.  ``Draws`` injects them instead (the tests
give the JAX package's draws; torch cannot reproduce threefry, F4).

Spans (``utils/trace.py``; none synchronises): ``ppo.rollout`` holds each
step's ``ppo.sample`` (the forward and the draw) and the env's own spans;
``ppo.autoreset`` holds ``batch.reset_local``; ``ppo.update`` holds
``ppo.gae`` (the last value's forward and GAE), each minibatch's
``ppo.grads`` (forward, backward and the mesh's ``all_reduce``s) and
``ppo.optim`` (clip and Adam).  Counters: ``ppo.samples`` (+T*S*N a
rollout, this rank's), ``ppo.minibatches`` and ``ppo.reset_scenes`` (the
scenes the autoreset found finished, from the mask it reads on the host).
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch.func import functional_call

from img_env_tpu_torch.core.state import Observation, map_tree
from img_env_tpu_torch.env import rewards as rewards_mod
from img_env_tpu_torch.env.sampler import sample_scenario_retry
from img_env_tpu_torch.models.policy import (CrowdNavPolicy, full_float32,
                                             sample_action)
from img_env_tpu_torch.parallel.batched_env import BatchedNavEnv
from img_env_tpu_torch.parallel.mesh import (MODEL_AXIS, SCENE_AXIS,
                                             tp_param_shardings)
from img_env_tpu_torch.train import optim
from img_env_tpu_torch.utils import trace

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
    ``perms`` [epochs, T*S*N] int64 permutations; S counts the global
    scenes under a mesh."""

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


def all_sum(x: Tensor, group=None) -> Tensor:
    """``x`` summed over the ranks of ``group`` in place (None: this
    process alone)."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def global_mean(x: Tensor, group=None) -> Tensor:
    """The mean of ``x`` over the ranks of ``group`` (each rank's block
    of a global tensor): the summed sums over the summed counts."""
    sc = all_sum(torch.stack([x.sum(), x.new_tensor(float(x.numel()))]),
                 group)
    return sc[0] / sc[1]


def _split(flat: Tensor, like: Dict[str, Tensor], keys) -> List[Tensor]:
    """``flat``'s leading values cut into tensors shaped as ``like[k]``."""
    out, at = [], 0
    for k in keys:
        n = like[k].numel()
        out.append(flat[at:at + n].reshape(like[k].shape))
        at += n
    return out


def take(data, idx: Tensor):
    """The minibatch ``idx`` of ``rollout_data``'s samples."""
    feats, *rest = data
    return (tuple(None if f is None else f[idx] for f in feats),
            *(x[idx] for x in rest))


_LOG_2PI = math.log(2 * math.pi)
_ENT_CONST = 0.5 * math.log(2 * math.pi * math.e)


def normalise_advantages(advs: Tensor, group=None):
    """Advantages over their mean and population std (``jnp.std``'s two
    passes: the mean, then the mean square deviation from it), and the
    sample count; with a scene ``group`` the mean, the deviation and the
    count are sums over the group's ranks (each holding its share of a
    global minibatch)."""
    stats = all_sum(torch.stack([advs.sum(), advs.new_tensor(
        float(advs.shape[0]))]), group)
    n = stats[1]
    mu = stats[0] / n
    var = all_sum((advs - mu).square().sum(), group) / n
    return (advs - mu) / (torch.sqrt(var) + 1e-8), n


def loss_terms(out, act, logp_old, advs, returns, cfg: PpoConfig):
    """Each sample's clipped-surrogate, value and entropy terms ([B] each)
    from the policy's (mean, log_std, value) and normalised advantages."""
    mean, log_std, value = out
    logp = (-0.5 * ((act - mean) / torch.exp(log_std)) ** 2
            - log_std - 0.5 * _LOG_2PI).sum(-1)
    ratio = torch.exp(logp - logp_old)
    pg = -torch.minimum(
        ratio * advs,
        torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * advs)
    return pg, 0.5 * (value - returns) ** 2, (log_std + _ENT_CONST).sum(-1)


def minibatch_loss(model: CrowdNavPolicy, params: Dict[str, Tensor], mb,
                   cfg: PpoConfig, group=None, forward=None):
    """The clipped PPO loss on one minibatch ``(feats, act, logp_old, advs,
    returns)``; returns (loss, {pg_loss, vf_loss, entropy}).  Advantages
    are normalised by ``normalise_advantages``.  With a scene ``group``
    the minibatch is this rank's share of a global one and the loss is
    this rank's terms summed over the global count (the group's losses sum
    to the minibatch's loss).  ``forward(params, feats)`` replaces the
    model's forward (the tensor-parallel one)."""
    feats, act, logp_old, advs, returns = mb
    advs, n = normalise_advantages(advs, group)
    out = (functional_call(model, params, tuple(feats)) if forward is None
           else forward(params, feats))
    pg, vf, ent = (x.sum() / n for x in loss_terms(out, act, logp_old, advs,
                                                    returns, cfg))
    loss = pg + cfg.vf_coef * vf - cfg.ent_coef * ent
    return loss, {"pg_loss": pg, "vf_loss": vf, "entropy": ent}


def loss_and_grads(model, params, mb, cfg: PpoConfig, group=None,
                   forward=None):
    """``minibatch_loss`` and its gradient per parameter, TF32 off in the
    forward and the backward, whatever the caller's flags.  With a scene
    ``group``: this rank's share of both (its samples' terms; a rank
    without samples in the minibatch gets zeros)."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with full_float32():
        loss, aux = minibatch_loss(model, p, mb, cfg, group, forward)
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for g, v in zip(grads, p.values())]
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            dict(zip(p, grads)))


# The error model of a gradient taken in another summation order or on
# another device (float32, TF32 off): each leaf within GRAD_REL of the
# largest sum of its per-sample terms' magnitudes (``grad_term_sums``),
# plus GRAD_ABS for a leaf whose terms are all ~0 (the attention's key
# bias, whose exact gradient is 0).  Measured on the H100 at the stage-5
# shapes, minibatches of 256 (tools/grad_terms.py over 42, and
# tests/test_torch_card_train.py::test_train_gradients_card_equals_cpu):
# float32 at <= 4.5e-5 of that scale (a ReLU unit within rounding of 0
# adds one sample's whole term on one device only), TF32 convolutions at
# >= 3.3e-4; GRAD_REL lies between them with a factor of 2 or more on
# each side.
GRAD_REL = 1e-4
GRAD_ABS = 1e-8


def grad_term_sums(model, params, mb, cfg: PpoConfig) -> Dict[str, Tensor]:
    """The error model of ``loss_and_grads``' gradient: per parameter
    element, the sum over the minibatch's samples of the magnitude of the
    sample's term (the loss is a sum of per-sample terms over the
    normalised advantages).  Summed in another order, or from terms
    rounded otherwise, the gradient moves by a fraction of this sum, which
    the gradient itself can lie far below where the terms cancel.  One
    forward and backward per sample, TF32 off."""
    feats, act, logp_old, advs, returns = mb
    advs, n = normalise_advantages(advs)
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    sums = {k: torch.zeros_like(v) for k, v in params.items()}
    with full_float32():
        for i in range(advs.shape[0]):
            one = lambda x: None if x is None else x[i:i + 1]
            out = functional_call(model, p, tuple(one(f) for f in feats))
            pg, vf, ent = loss_terms(out, one(act), one(logp_old),
                                     one(advs), one(returns), cfg)
            term = (pg + cfg.vf_coef * vf - cfg.ent_coef * ent).sum() / n
            grads = torch.autograd.grad(term, list(p.values()),
                                        allow_unused=True)
            for k, g in zip(p, grads):
                if g is not None:
                    sums[k] += g.abs()
    return sums


def grad_error_ratios(grads, want, sums) -> Dict[str, float]:
    """Per leaf: max |grads - want| over the error model's tolerance
    (GRAD_REL times the leaf's largest term sum, plus GRAD_ABS); 1 is the
    limit."""
    return {k: float((grads[k].to(w.device) - w).abs().max())
            / (GRAD_REL * float(sums[k].max()) + GRAD_ABS)
            for k, w in want.items()}


def make_train_step(env: BatchedNavEnv, model: CrowdNavPolicy,
                    cfg: PpoConfig = PpoConfig(),
                    tx: Optional[optim.GradientTransformation] = None):
    """Returns ``(init_fn(params), train_step(ts, states, obs, generator,
    draws=None, timings=None))``.  ``train_step`` returns ``(ts, states,
    obs, metrics)`` with the metrics as device scalars: loss, pg_loss,
    vf_loss, entropy (means over epochs x minibatches), reward_mean
    (unscaled), arrive_rate and collision_rate (before the autoreset), and
    reset_scenes (how many scenes the autoreset redrew); under the env's
    mesh each is the global one.  ``timings``: a dict that receives the
    host seconds of the rollout, the autoreset and the update (the device
    synchronised at each boundary).  Under a mesh ``init_fn`` broadcasts
    the parameters from the mesh's first rank."""
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
    n_rob = ecfg.robot.total
    mesh = env.mesh
    scene_group = model_group = plan = None
    if mesh is not None:
        scene_group = mesh.get_group(SCENE_AXIS)
        if mesh.size(1) > 1:
            from img_env_tpu_torch.parallel.tp import tp_forward

            model_group = mesh.get_group(MODEL_AXIS)
            plan = tp_param_shardings(model.state_dict(), mesh)

    def forward(params, feats):
        if plan is None:
            return functional_call(model, params, tuple(feats))
        return tp_forward(model, params, plan, model_group, *feats)

    def init_fn(params) -> TrainState:
        if mesh is not None:
            params = {k: v.clone() for k, v in params.items()}
            for g in (scene_group, model_group):
                if g is not None:
                    for v in params.values():
                        dist.broadcast(v, src=dist.get_global_rank(g, 0),
                                       group=g)
        return TrainState(params, tx.init(params),
                          torch.zeros((), dtype=torch.int32, device=dev))

    def policy_dist(params, feats):
        with torch.no_grad():
            return forward(params, feats)

    def rows(b: int) -> slice:
        """This rank's rows of a global flat [S*N] robot axis of ``b``
        local rows."""
        blk = env.block(env.global_scenes(b // n_rob))
        return slice(blk.start * n_rob, blk.stop * n_rob)

    def rollout(params, states, obs, generator, eps):
        """T env steps with training-stack semantics: the paper reward
        (SensorsPaperRewardWrapper), rewards of already-done robots masked
        (MultiRobotCleanWrapper's is_clean).  No host sync.  Under a mesh
        each step draws the global S*N rows of noise and keeps its own."""
        traj: List[tuple] = []
        for t in range(cfg.unroll):
            with trace.span("ppo.sample"):
                feats = obs_features(obs, use_ped)
                out = policy_dist(params, feats)
                e = None if eps is None else eps[t]
                if mesh is not None:
                    b = out[0].shape[0]
                    if e is None:
                        e = torch.randn(
                            (env.global_scenes(b // n_rob) * n_rob,)
                            + out[0].shape[1:], generator=generator,
                            device=dev, dtype=out[0].dtype)
                    e = e[rows(b)]
                # store the RAW Gaussian sample for the loss; only the env
                # command is clipped
                act, logp, value = sample_action(out, generator, e)
                act_env = torch.clamp(act, lo, hi)
                s, n = obs.vector_states.shape[:2]
                act_sn = act_env.reshape(s, n, act_env.shape[-1])
                actions = torch.cat([act_sn, act_sn.new_zeros((s, n, 1))],
                                    -1)
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
        trace.count("ppo.samples", cfg.unroll * act.shape[0])
        return states, obs, traj

    def autoreset(states, obs, generator, reset_samples):
        """NeverStop between rollouts: the scenes with every robot down or
        past the time limit restart (fresh layouts, no carry).  Reads the
        finished mask on the host; under a mesh the global one (every rank
        draws the samples of every finished scene, in order, and resets
        its own).  Returns (states, obs, scenes reset)."""
        r = states.robots
        done_now = (torch.clamp(r.collision, 0, 1)
                    + r.arrive.to(torch.int32)) > 0
        finished = done_now.all(dim=-1) | (states.step >= time_max)
        s_loc = finished.shape[0]
        blk = env.block(env.global_scenes(s_loc))
        if mesh is not None:
            flags = torch.zeros(env.global_scenes(s_loc), dtype=torch.int32,
                                device=dev)
            flags[blk] = finished.to(torch.int32)
            finished = all_sum(flags, scene_group) > 0
        ids = torch.nonzero(finished.cpu()).flatten().tolist()
        trace.count("ppo.reset_scenes", len(ids))
        if not ids:
            return states, obs, 0
        if reset_samples is not None:
            samples = [reset_samples[i] for i in ids]
        else:
            samples = [sample_scenario_retry(spec, generator, dev)
                       for _ in ids]
        mine = [k for k, i in enumerate(ids) if blk.start <= i < blk.stop]
        if not mine:
            return states, obs, len(ids)
        rstates, robs = env.reset_local([samples[k] for k in mine])
        idx = torch.as_tensor([ids[k] - blk.start for k in mine],
                              dtype=torch.int64, device=dev)
        put = lambda old, new: old.index_copy(0, idx, new)
        return (map_tree(put, states, rstates), map_tree(put, obs, robs),
                len(ids))

    def local_samples(idx: Tensor, b_loc: int) -> Tensor:
        """The positions in this rank's [T*B_loc] samples of the global
        sample indices ``idx`` (i = t*B + b over the global B) that fall in
        its scenes, in ``idx``'s order."""
        if mesh is None:
            return idx
        r = rows(b_loc)
        b_all = env.global_scenes(b_loc // n_rob) * n_rob
        t, b = idx // b_all, idx % b_all
        keep = (b >= r.start) & (b < r.stop)
        return (t * b_loc + b - r.start)[keep]

    def reduce_grads(grads, metrics):
        """Under a mesh: the gradients and the loss terms summed over the
        ranks (over the model axis only for the sharded parameters, whose
        ranks hold disjoint pieces)."""
        if mesh is None:
            return grads, metrics
        keys = list(grads)
        if model_group is not None:
            sh = [k for k in keys if plan[k][1].is_shard()]
            flat = all_sum(torch.cat([grads[k].reshape(-1) for k in sh]),
                           model_group)
            grads = dict(grads, **dict(zip(sh, _split(flat, grads, sh))))
        flat = all_sum(torch.cat([grads[k].reshape(-1) for k in keys]
                                 + [metrics]), scene_group)
        return (dict(zip(keys, _split(flat, grads, keys))),
                flat[-metrics.shape[0]:])

    def minibatch_grads(params, data, idx: Tensor):
        """The gradient of the minibatch of ``rollout_data``'s samples at
        the global sample indices ``idx``, and its (loss, pg_loss, vf_loss,
        entropy); under a mesh summed over the ranks."""
        b_loc = data[1].shape[0] // cfg.unroll
        loss, aux, grads = loss_and_grads(
            model, params, take(data, local_samples(idx, b_loc)), cfg,
            scene_group, forward)
        return reduce_grads(grads, torch.stack(
            [loss, aux["pg_loss"], aux["vf_loss"], aux["entropy"]]))

    def update(ts: TrainState, traj, obs, generator, perms):
        with trace.span("ppo.gae"):
            last_value = policy_dist(ts.params,
                                     obs_features(obs, use_ped))[-1]
            data, reward = rollout_data(traj, last_value, cfg)
        b_loc = reward.shape[1]
        tb = cfg.unroll * env.global_scenes(b_loc // n_rob) * n_rob
        n_mb = max(1, min(cfg.minibatches, tb))
        mb_size = tb // n_mb
        params, opt_state = ts.params, ts.opt_state
        ms = []
        for e in range(cfg.epochs):
            perm = (perms[e] if perms is not None else
                    torch.randperm(tb, generator=generator, device=dev))
            idxs = perm[: mb_size * n_mb].reshape(n_mb, mb_size)
            for idx in idxs:
                with trace.span("ppo.grads"):
                    trace.count("ppo.minibatches")
                    grads, m = minibatch_grads(params, data, idx)
                with trace.span("ppo.optim"):
                    updates, opt_state = tx.update(grads, opt_state, params)
                    params = optim.apply_updates(params, updates)
                ms.append(m)
        m = torch.stack(ms).mean(0)
        metrics = dict(zip(("loss", "pg_loss", "vf_loss", "entropy"), m))
        metrics["reward_mean"] = global_mean(reward, scene_group)
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
        with trace.span("ppo.rollout"):
            states, obs, traj = rollout(ts.params, states, obs, generator,
                                        None if draws is None else draws.eps)
            # episode outcome rates at the end of the unroll, BEFORE scenes
            # re-draw (the learning curve's signal)
            r = states.robots
            ep_stats = {
                "arrive_rate": global_mean(r.arrive.to(torch.float32),
                                           scene_group),
                "collision_rate": global_mean(torch.clamp(
                    r.collision, 0, 1).to(torch.float32), scene_group),
            }
        t0 = lap(timings, "rollout", t0)
        n_reset = 0
        if cfg.autoreset:
            with trace.span("ppo.autoreset"):
                states, obs, n_reset = autoreset(
                    states, obs, generator,
                    None if draws is None else draws.reset)
        t0 = lap(timings, "autoreset", t0)
        with trace.span("ppo.update"):
            ts, metrics = update(ts, traj, obs, generator,
                                 None if draws is None else draws.perms)
        lap(timings, "update", t0)
        metrics.update(ep_stats)
        metrics["reset_scenes"] = n_reset
        return ts, states, obs, metrics

    # the unroll alone, (params, states, obs, generator, eps) -> (states,
    # obs, traj): a caller can check it for host syncs; the policy's
    # forward (params, feats) and one minibatch's gradient (params, data,
    # idx) -> (grads, loss terms), as the update takes them
    train_step.rollout = rollout
    train_step.forward = policy_dist
    train_step.minibatch_grads = minibatch_grads
    return init_fn, train_step
