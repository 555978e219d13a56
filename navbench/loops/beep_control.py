"""The beep control loop: the ``control`` loop (one ``NavEnv``: every
robot of one scene, ``envloop.py``) over a crowd that answers the robots'
beeps (``ervoscene``), with the beep responses' uniform draws made by the
harness, as ``beep_batch`` makes them for a batch.

Each step draws ``beep_u`` [N] uniform on the card from a generator
seeded from the seed (a stream of its own, as in ``beep_batch``) and hands
it to ``NavEnv.step(..., beep_u=)``; a compared step keeps it.  The
reference is ``beep_batch``'s (the ORCA env, ``reference/env/orca_env.py``,
on segments it splits itself, and the compared number ``beeps``) on a
scene axis of one, with ``reference/mpc/orca_head.py``'s controller for
the actor (the reference controller's, with the 'orca' head besides).

In the span phase of a ``--trace 1`` run the program's tracing
(``img_env_tpu_torch.utils.trace``) is on around each act, unless
something else has it on already: after each step the host ms inside
``mpc.predict`` go into ``spans['predict']`` and the step's
``predict.agents`` count into ``counts['predict.agents']``.  In plain and
profiled steps tracing stays off.
"""

import importlib
import os

import numpy as np
import torch

from navbench.drive import tmap
from navbench.envloop import EnvLoop
from navbench.parts import load_part
from navbench.reference.mpc import orca_head

beep_batch = load_part(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "loops", "beep_batch")


class Reference(beep_batch.BeepReference):
    """``BeepReference`` over one scene: each compared step gains a scene
    axis of one for the reference's scene step."""

    def __init__(self, ref, drive, control=None):
        ref.controller = orca_head
        super().__init__(ref, drive, control)

    def step(self, state, actions):
        one = lambda x: x[None]
        u, self.beep_u = self.beep_u, self.beep_u[None]
        try:
            new, obs, done = super().step(tmap(one, state), actions[None])
        finally:
            self.beep_u = u
        self.beeps = self.beeps[0]
        first = lambda x: x[0]
        return tmap(first, new), tmap(first, obs), done[0]


class _TracedActor:
    """The actor, with the program's tracing on around its act while the
    loop's ``trace_act`` is set."""

    def __init__(self, actor, loop):
        self.actor, self.loop = actor, loop

    def act(self, keep: bool):
        if not self.loop.trace_act:
            return self.actor.act(keep)
        trace = self.loop.trace
        trace.enable()
        try:
            return self.actor.act(keep)
        finally:
            trace.disable()

    def __getattr__(self, name):
        return getattr(self.actor, name)


class Loop(EnvLoop):
    batch = False
    Reference = Reference

    def setup(self):
        super().setup()
        self.core = beep_batch._Beeping(self.core, self)
        seed = int(np.random.default_rng([self.seed, 2]).integers(2 ** 62))
        self.beep_gen = torch.Generator(device=self.dev).manual_seed(seed)
        self.trace = importlib.import_module("img_env_tpu_torch.utils.trace")
        self.actor = _TracedActor(self.actor, self)
        self.trace_act = False
        self.counts = {}

    def step(self) -> None:
        self.beep_u = torch.rand((self.robots,), generator=self.beep_gen,
                                 device=self.dev)
        self.trace_act = self.mode == "spans" and not self.trace.enabled()
        super().step()
        if self.pending is not None:     # this step is compared
            self.pending["beep_u"] = self.beep_u
        if self.trace_act:
            self.trace_act = False
            spans, counts = self.trace.drain()
            self.spans.setdefault("predict", []).append(sum(
                e - s for name, _, s, e in spans if name == "mpc.predict")
                / 1e6)
            self.counts.setdefault("predict.agents", []).append(
                counts.get("predict.agents", 0))
