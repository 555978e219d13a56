"""The MPPI actor: ``MpcController.act`` (one scene) or ``.act_scenes`` (a
batch) every step, with noise the harness draws on the card from the
seed.  Traffic keys: ``mppi`` = {samples, horizon, head}.  The reference's
controller replays each compared call from the program's controller state
and the same noise; it compares the commands, the nominal plan and the
costs."""

import torch

from navbench import check
from navbench.drive import clone


def _mppi(loop):
    m = loop.traffic["mppi"]
    return int(m["horizon"]), int(m["samples"]), m["head"]


class Actor:
    def __init__(self, loop):
        self.loop = loop
        horizon, samples, head = _mppi(loop)
        sut = loop.sut
        self.cfg = sut.MppiConfig(horizon=horizon, samples=samples)
        self.ctl = sut.MpcController(loop.core, self.cfg,
                                     ped_prediction=head, seed=loop.seed)
        self.mss = None

    def reset(self):
        lp = self.loop
        self.mss = (self.ctl.init_scenes_state(lp.scenes) if lp.batch
                    else self.ctl.init_state())

    def act(self, keep: bool):
        """(commands, what the check replays); ``keep``: a compared step
        waits for this call, so its controller state is copied."""
        lp = self.loop
        lead = (lp.scenes,) if lp.batch else ()
        noise = torch.randn(
            lead + (lp.robots, self.cfg.samples, self.cfg.horizon, 2),
            generator=lp.gen, device=lp.dev)
        mss_in = clone(self.mss) if keep else None
        with lp.region("act"):
            call = self.ctl.act_scenes if lp.batch else self.ctl.act
            actions, self.mss, costs = call(lp.states, self.mss, noise)
        return actions, {"mss": mss_in, "noise": noise, "costs": costs,
                         "nominal": self.mss.nominal}

    def redraw(self, idx):
        """Redrawn scenes start from a zero plan."""
        self.mss = self.mss._replace(
            nominal=self.mss.nominal.index_fill(0, idx, 0.0))


class Check:
    def __init__(self, replay):
        self.replay = replay
        ref, d = replay.ref, replay.drive
        horizon, samples, head = _mppi(d)
        self.ctl = ref.controller.MpcController(
            replay.env, ref.mppi.MppiConfig(horizon=horizon, samples=samples),
            ped_prediction=head, seed=d.seed)

    def compare(self, rd, state, obs, rec):
        ref, c = self.replay.ref, self.replay.control
        mss = check.to_ref(ref, rec["mss"])
        call = self.ctl.act_scenes if self.replay.drive.batch else self.ctl.act
        actions, ms, costs = call(check.lower(state, c), check.lower(mss, c),
                                  check.lower(rec["noise"], c))
        rd.put("actions", max(check.gap(rec["actions"], actions),
                              check.gap(rec["nominal"], ms.nominal)))
        scale = max(1.0, float(costs.abs().max()))
        rd.put("mpc_costs", check.gap(rec["costs"], costs) / scale)
