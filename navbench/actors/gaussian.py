"""The Gaussian head of a policy under PPO training (the ``ppo`` loop).

The trainer samples its own actions; what the harness gives it are the
draws the trainer would otherwise make itself.  ``Actor`` draws, for each
update, the standard normals ``eps`` [T, S*N, act_dim] of its rollout
and one permutation of the T*S*N samples per epoch, on the card from a
generator seeded from the seed (a stream of its own: the program's
generators are seeded with the seed itself).  ``Check`` is the
reference's side of the draw: the reference policy's mean, log-std and
value on the program's observations, and the same ``eps`` turned into the
raw action, its log-probability and the clipped env command.
"""

import numpy as np
import torch

from navbench.reference.train import ppo as ref_ppo


class Actor:
    def __init__(self, loop):
        self.loop = loop
        seed = int(np.random.default_rng([loop.seed, 3]).integers(2 ** 62))
        self.gen = torch.Generator(device=loop.dev).manual_seed(seed)

    def draws(self, unroll: int, rows: int, act_dim: int, epochs: int):
        """(eps [unroll, rows, act_dim], perms [epochs, unroll * rows])."""
        dev = self.loop.dev
        eps = torch.randn((unroll, rows, act_dim), generator=self.gen,
                          device=dev)
        perms = torch.stack([torch.randperm(unroll * rows,
                                            generator=self.gen, device=dev)
                             for _ in range(epochs)])
        return eps, perms


class Check:
    def __init__(self, replay):
        self.replay = replay
        cfg = replay.cfg
        ranges = cfg.continuous_actions[: cfg.act_dim]
        dev = replay.drive.dev
        self.lo = torch.as_tensor([r[0] for r in ranges],
                                  dtype=torch.float32, device=dev)
        self.hi = torch.as_tensor([r[1] for r in ranges],
                                  dtype=torch.float32, device=dev)

    def act(self, params, feats, eps):
        """(raw action, log-probability, command, value) of the reference
        policy at ``params`` on ``feats`` with the draws ``eps``."""
        with torch.no_grad():
            mean, log_std, value = ref_ppo.forward(self.replay.model, params,
                                                   feats)
        act, logp, command = ref_ppo.sample(mean, log_std, eps, self.lo,
                                            self.hi)
        return act, logp, command, value
