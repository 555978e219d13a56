"""The random actor: uniform commands within the configuration's limits,
drawn on the card from the seed (``examples/run_random``'s traffic).  The
commands are the harness's own input, so the reference has nothing of
the actor's to compare."""

import torch


class Actor:
    def __init__(self, loop):
        self.loop = loop
        lim = loop.env_cfg.continuous_actions
        self.lo = torch.tensor([lim[0][0], lim[1][0]], device=loop.dev)
        self.hi = torch.tensor([lim[0][1], lim[1][1]], device=loop.dev)

    def reset(self):
        pass

    def act(self, keep: bool):
        lp = self.loop
        lead = ((lp.scenes,) if lp.batch else ()) + (lp.robots,)
        u = torch.rand(lead + (2,), generator=lp.gen, device=lp.dev)
        act = self.lo + u * (self.hi - self.lo)
        return torch.cat([act, torch.zeros_like(act[..., :1])], -1), {}

    def redraw(self, idx):
        pass


class Check:
    def __init__(self, replay):
        pass

    def compare(self, rd, state, obs, rec):
        pass
