"""Gradient transformations: the port's own copy of the optax rules that
``img_env_tpu.train.ppo`` trains with (``clip_by_global_norm``, ``adam``,
``sgd``, ``chain``).

A transformation is an (init, update) pair over parameter dicts of one key
order (``TrainState.params``):

    tx = chain(clip_by_global_norm(0.5), adam(3e-4))
    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    params = apply_updates(params, updates)

Each rule computes what optax computes, float32 op by op:
  * ``clip_by_global_norm``: g_norm = sqrt(sum over leaves of sum(g*g));
    g is kept where g_norm < max_norm, else (g / g_norm) * max_norm.  (Not
    ``torch.nn.utils.clip_grad_norm_``, which divides by norm + 1e-6 and
    clamps its coefficient.)
  * ``adam``: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, an int32
    count, bias corrections 1 - b**count in float32, the update
    mu_hat / (sqrt(nu_hat + eps_root) + eps) times -lr.  (Not
    ``torch.optim.Adam``, which lerps, uses addcdiv and float64 step
    sizes.)
  * ``sgd``: the update -lr * g (no momentum).
The leaves go through ``torch._foreach_*`` ops, one launch per op for all
of them; each op rounds as the per-tensor op does.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor
Params = Dict[str, Tensor]


class GradientTransformation(NamedTuple):
    init: Callable      # params -> state
    update: Callable    # (updates, state, params) -> (updates, state)


class AdamState(NamedTuple):
    count: Tensor       # [] int32
    mu: Params
    nu: Params


def _leaves(tree: Params):
    return list(tree.values())


def _like(tree: Params, leaves) -> Params:
    return dict(zip(tree.keys(), leaves))


def global_norm(updates: Params) -> Tensor:
    """sqrt of the sum over leaves (in key order) of each leaf's sum of
    squares, as optax's ``global_norm``."""
    sums = [torch.sum(g * g) for g in _leaves(updates)]
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return torch.sqrt(total)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init(params):
        return ()

    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        leaves = _leaves(updates)
        clipped = torch._foreach_mul(torch._foreach_div(leaves, g_norm),
                                     float(max_norm))
        out = [torch.where(trigger, g, c) for g, c in zip(leaves, clipped)]
        return _like(updates, out), state

    return GradientTransformation(init, update)


def scale(step_size: float) -> GradientTransformation:
    def init(params):
        return ()

    def update(updates, state, params=None):
        return _like(updates, torch._foreach_mul(_leaves(updates),
                                                 float(step_size))), state

    return GradientTransformation(init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    def init(params):
        leaf = next(iter(params.values()))
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
        return AdamState(torch.zeros((), dtype=torch.int32,
                                     device=leaf.device), zeros(), zeros())

    def update(updates, state, params=None):
        g = _leaves(updates)
        mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - b1),
                                torch._foreach_mul(_leaves(state.mu), b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2),
            torch._foreach_mul(_leaves(state.nu), b2))
        imax = torch.iinfo(torch.int32).max
        count = torch.where(state.count < imax, state.count + 1,
                            state.count)
        c = count.to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=c.device)
        bc1 = one - torch.pow(one.new_tensor(b1), c)
        bc2 = one - torch.pow(one.new_tensor(b2), c)
        mu_hat = torch._foreach_div(mu, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        if eps_root:
            nu_hat = torch._foreach_add(nu_hat, float(eps_root))
        den = torch._foreach_add(torch._foreach_sqrt(nu_hat), float(eps))
        out = torch._foreach_div(mu_hat, den)
        return _like(updates, out), AdamState(count, _like(updates, mu),
                                              _like(updates, nu))

    return GradientTransformation(init, update)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in txs)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(txs, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> GradientTransformation:
    """optax.adam(lr, ...): ``scale_by_adam`` then ``scale(-lr)``."""
    return chain(scale_by_adam(b1, b2, eps, eps_root), scale(-lr))


def sgd(lr: float) -> GradientTransformation:
    """optax.sgd(lr) without momentum: the update -lr * g."""
    return scale(-lr)


def apply_updates(params: Params, updates: Params) -> Params:
    return _like(params, torch._foreach_add(_leaves(params),
                                            _leaves(updates)))


def adam_state_from_numpy(count, mu: Dict[str, np.ndarray],
                          nu: Dict[str, np.ndarray],
                          device="cuda") -> AdamState:
    """optax's ``ScaleByAdamState`` (count, mu, nu) as numpy, mu and nu
    already in the port's parameter names and layouts (each through
    ``models.policy.policy_params_from_numpy``), as the port's state."""
    dev = torch.device(device)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return AdamState(torch.as_tensor(np.array(count, np.int32),
                                     device=dev),
                     {k: t(v) for k, v in mu.items()},
                     {k: t(v) for k, v in nu.items()})

