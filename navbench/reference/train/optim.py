"""The gradient clip and Adam of the port's trainer, leaf by leaf: a
frozen copy of ``img_env_tpu_torch.train.optim``'s
``chain(clip_by_global_norm(max_norm), adam(lr))``, the optax rules.

Departure: the port applies each rule to every leaf at once through
``torch._foreach_*``; this copy loops over the leaves with the per-tensor
ops, which round each element as the ``_foreach`` ops do.  Parameter
dicts keep the policy's state-dict order, which the global norm sums
in.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

Tensor = torch.Tensor
Params = Dict[str, Tensor]

B1, B2, EPS = 0.9, 0.999, 1e-8     # optax.adam's defaults


class Adam(NamedTuple):
    count: Tensor       # [] int32
    mu: Params
    nu: Params


def global_norm(grads: Params) -> Tensor:
    """sqrt of the sum over leaves, in key order, of each leaf's sum of
    squares (optax's ``global_norm``)."""
    total = None
    for g in grads.values():
        s = torch.sum(g * g)
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: Params, max_norm: float):
    """(clipped gradients, factor): each leaf kept where the global norm
    is under ``max_norm``, else ``(g / norm) * max_norm``; ``factor`` is
    ``max_norm / norm`` where it clips, else 1 (the error model's scale of
    the clipped gradient)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    out = {k: torch.where(keep, g, (g / norm) * float(max_norm))
           for k, g in grads.items()}
    factor = torch.where(keep, torch.ones_like(norm), max_norm / norm)
    return out, factor


def adam_step(params: Params, grads: Params, state: Adam, lr: float):
    """One optax ``adam(lr)`` step: the moments, an int32 count, float32
    bias corrections ``1 - b ** count``, the update ``-lr * mu_hat /
    (sqrt(nu_hat) + eps)`` added to each parameter.  Returns (params,
    state)."""
    mu = {k: g * (1.0 - B1) + state.mu[k] * B1 for k, g in grads.items()}
    nu = {k: (g * g) * (1.0 - B2) + state.nu[k] * B2
          for k, g in grads.items()}
    imax = torch.iinfo(torch.int32).max
    count = torch.where(state.count < imax, state.count + 1, state.count)
    c = count.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=c.device)
    bc1 = one - torch.pow(one.new_tensor(B1), c)
    bc2 = one - torch.pow(one.new_tensor(B2), c)
    out = {}
    for k, p in params.items():
        step = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS)
        out[k] = p + step * (-lr)
    return out, Adam(count, mu, nu)
