"""The one-process parts of the port's PPO update, frozen in plain torch
(a copy of ``img_env_tpu_torch.train.ppo`` without the mesh): the
action draw from given standard normals, the paper reward under the clean
mask, GAE, advantage normalisation, the clipped loss terms, the minibatch
loss and its gradient, and the gradient's error model.

Float32 with TF32 off: the policy's forward and the backward run inside
the reference policy's ``full_float32`` (``navbench/reference/models/
policy.py``), looked up when called so that the harness's 'tf32' control
can lift it.

Departures from the port, none of which changes a result:

* no mesh: a minibatch is this process's samples, the advantages are
  normalised over them alone and nothing is summed over ranks (the port's
  ``all_reduce``s over a world of one add nothing);
* the draws are always given (the port draws from its generator where
  they are not);
* ``term_sums`` takes the per-sample gradients with ``torch.func``
  (``vmap`` over ``grad``, in chunks) where the port's
  ``grad_term_sums`` loops over the samples in Python; it sums the same
  magnitudes.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch
from torch.func import functional_call, grad, vmap

from navbench.reference.env import rewards as rewards_mod
from navbench.reference.models import policy as policy_mod

Tensor = torch.Tensor

_LOG_2PI = math.log(2 * math.pi)
_ENT_CONST = 0.5 * math.log(2 * math.pi * math.e)

# The error model of a gradient taken in another summation order or on
# another device (float32, TF32 off), copied from the port's trainer: each
# leaf within GRAD_REL of the largest sum of its per-sample terms'
# magnitudes (``term_sums``), plus GRAD_ABS for a leaf whose terms are all
# ~0 (the attention's key bias, whose exact gradient is 0).  Measured on
# the H100 at the stage-5 shapes, minibatches of 256: float32 at <= 4.5e-5
# of that scale (a ReLU unit within rounding of 0 adds one sample's whole
# term on one device only), TF32 convolutions at >= 3.3e-4; GRAD_REL lies
# between them with a factor of 2 or more on each side.
GRAD_REL = 1e-4
GRAD_ABS = 1e-8


class Settings(NamedTuple):
    """The port's ``PpoConfig``, its defaults copied."""

    unroll: int = 8
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    epochs: int = 4
    minibatches: int = 4
    max_grad_norm: float = 0.5
    reward_scale: float = 1.0


def features(obs, use_ped: bool):
    """An [S, N, ...] observation as the policy's [B, ...] inputs."""
    sm = obs.sensor_maps
    b = sm.shape[0] * sm.shape[1]
    sm = sm.reshape(b, 1, sm.shape[-2], sm.shape[-1])
    vs = obs.vector_states.reshape(b, -1)
    if not use_ped:
        return sm, vs, None, None
    pm = obs.ped_maps.reshape(b, 3, obs.ped_maps.shape[-2],
                              obs.ped_maps.shape[-1])
    return sm, vs, pm, obs.ped_vector_states.reshape(b, -1)


def forward(model, params: Dict[str, Tensor], feats):
    """(mean, log_std, value) of the policy ``model`` at ``params``."""
    return functional_call(model, params, tuple(feats))


def sample(mean: Tensor, log_std: Tensor, eps: Tensor, lo: Tensor,
           hi: Tensor):
    """The Gaussian head's draw from standard normals ``eps``: (the raw
    action the loss keeps, its log-probability, the env command clipped to
    [lo, hi])."""
    act = mean + torch.exp(log_std) * eps
    logp = (-0.5 * ((act - mean) / torch.exp(log_std)) ** 2
            - log_std - 0.5 * _LOG_2PI).sum(-1)
    return act, logp, torch.clamp(act, lo, hi)


def clean_reward(obs, alive: Tensor, ped_safety: float) -> Tensor:
    """SensorsPaperRewardWrapper's reward of each robot [S, N], 0 where the
    robot was already done before the step (MultiRobotCleanWrapper)."""
    d = obs.vector_states.shape[-1]
    r = rewards_mod.paper_reward(
        obs.vector_states.reshape(-1, d), obs.is_collisions.reshape(-1),
        obs.is_arrives.reshape(-1), obs.step_ds.reshape(-1),
        obs.ped_min_dists.reshape(-1), ped_safety).reshape(alive.shape)
    return torch.where(alive, r, torch.zeros_like(r))


def gae(values: Tensor, rewards: Tensor, dones: Tensor, last_value: Tensor,
        gamma: float, lam: float) -> Tensor:
    """Generalised advantages over [T, B] by a reverse loop over T."""
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    out = [None] * values.shape[0]
    for t in range(values.shape[0] - 1, -1, -1):
        nonterm = 1.0 - (dones[t] > 0).to(torch.float32)
        delta = rewards[t] + gamma * v_next * nonterm - values[t]
        adv_next = delta + gamma * lam * nonterm * adv_next
        v_next = values[t]
        out[t] = adv_next
    return torch.stack(out)


def normalise(advs: Tensor):
    """Advantages over their mean and population std (two passes), and
    their count."""
    n = advs.new_tensor(float(advs.shape[0]))
    mu = advs.sum() / n
    var = (advs - mu).square().sum() / n
    return (advs - mu) / (torch.sqrt(var) + 1e-8), n


def loss_terms(out, act, logp_old, advs, returns, clip: float):
    """Each sample's clipped-surrogate, value and entropy terms."""
    mean, log_std, value = out
    logp = (-0.5 * ((act - mean) / torch.exp(log_std)) ** 2
            - log_std - 0.5 * _LOG_2PI).sum(-1)
    ratio = torch.exp(logp - logp_old)
    pg = -torch.minimum(ratio * advs,
                        torch.clamp(ratio, 1 - clip, 1 + clip) * advs)
    return pg, 0.5 * (value - returns) ** 2, (log_std + _ENT_CONST).sum(-1)


def take(data, idx: Tensor):
    """The minibatch ``idx`` of ``(feats, act, logp_old, advs, returns)``."""
    feats, *rest = data
    return (tuple(None if f is None else f[idx] for f in feats),
            *(x[idx] for x in rest))


def loss_and_grads(model, params: Dict[str, Tensor], mb, cfg: Settings):
    """The clipped PPO loss of one minibatch, its (pg, vf, entropy) means
    and its gradient per parameter, TF32 off."""
    feats, act, logp_old, advs, returns = mb
    advs, n = normalise(advs)
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad(), policy_mod.full_float32():
        out = forward(model, p, feats)
        pg, vf, ent = (x.sum() / n for x in loss_terms(
            out, act, logp_old, advs, returns, cfg.clip))
        loss = pg + cfg.vf_coef * vf - cfg.ent_coef * ent
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(p.items(), grads)}
    return (torch.stack([loss, pg, vf, ent]).detach(), grads)


def term_sums(model, params: Dict[str, Tensor], mb, cfg: Settings,
              chunk: int = 32) -> Dict[str, Tensor]:
    """The error model's scale: per parameter element, the sum over the
    minibatch's samples of the magnitude of each sample's term of the
    loss's gradient (the loss is a sum of per-sample terms over the
    normalised advantages), TF32 off."""
    feats, act, logp_old, advs, returns = mb
    advs, n = normalise(advs)
    has = [f is not None for f in feats]
    detached = {k: v.detach() for k, v in params.items()}

    def term(p, fs, a, lo, ad, ret):
        it = iter(fs)
        one = tuple(next(it)[None] if h else None for h in has)
        out = forward(model, p, one)
        pg, vf, ent = loss_terms(out, a[None], lo[None], ad[None],
                                 ret[None], cfg.clip)
        return (pg + cfg.vf_coef * vf - cfg.ent_coef * ent).sum() / n

    per_sample = vmap(grad(term), in_dims=(None, 0, 0, 0, 0, 0))
    sums = {k: torch.zeros_like(v) for k, v in detached.items()}
    present = tuple(f for f in feats if f is not None)
    with torch.enable_grad(), policy_mod.full_float32():
        for a in range(0, advs.shape[0], chunk):
            sl = slice(a, a + chunk)
            g = per_sample(detached, tuple(f[sl] for f in present), act[sl],
                           logp_old[sl], advs[sl], returns[sl])
            for k in sums:
                sums[k] += g[k].abs().sum(0)
    return sums
