"""The policy actor: the configuration's policy (``policy``, an npz file)
through ``mean_action_fn``, its mean action every step.  The reference
loads the same file with its own loader and compares the actions it
takes on the observation that the reference's step produced."""

import torch

from navbench import check


class Actor:
    def __init__(self, loop):
        self.loop = loop
        sut = loop.sut
        policy = sut.load_policy_npz(loop.config["policy"], loop.env_cfg,
                                     loop.dev)
        self.fn = sut.mean_action_fn(policy, loop.env_cfg)

    def reset(self):
        pass

    def act(self, keep: bool):
        lp = self.loop
        with lp.region("policy"):
            act = self.fn(lp.gen, lp.obs)
        if act.shape[-1] < 3:   # (v, w) and a zero v_y
            act = torch.cat([act, act.new_zeros(act.shape[:-1] + (1,))], -1)
        return act, {}

    def redraw(self, idx):
        pass


class Check:
    def __init__(self, replay):
        self.replay = replay
        ref, d = replay.ref, replay.drive
        policy = ref.policy.load_policy_npz(d.config["policy"], replay.cfg,
                                            d.dev)
        self.fn = ref.policy.mean_action_fn(policy, replay.cfg)
        self.gen = torch.Generator(device=d.dev).manual_seed(0)

    def compare(self, rd, state, obs, rec):
        actions = self.fn(self.gen, check.lower(obs, self.replay.control))
        a = rec["actions"][..., :actions.shape[-1]]
        rd.put("actions", check.gap(a, actions))
