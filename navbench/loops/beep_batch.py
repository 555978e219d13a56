"""The beep batch loop: the ``batch`` loop (``envloop.py``) over a crowd
that answers the robots' beeps (``ervoscene``), with the beep responses'
uniform draws made by the harness.

Each step draws ``beep_u`` [S, N] uniform on the card from a generator
seeded from the seed (a stream of its own: the program's env generator,
seeded with the seed itself, would draw the same numbers) and hands it to
``BatchedNavEnv.step(..., beep_u=)``; a compared step keeps it.  The
reference (the ORCA env, ``reference/env/orca_env.py``) replays each
compared step with the same draws, on segments it splits itself from the
state's rectangles (one split per distinct scene layout), and adds the
compared number ``beeps``: robots whose beep response differs, summed
over the compared steps.
"""

import importlib

import numpy as np
import torch

from navbench import check
from navbench.envloop import EnvLoop, EnvReference


class _Beeping:
    """The program's batch env, each step handed the loop's draws."""

    def __init__(self, benv, loop):
        self.benv, self.loop = benv, loop

    def step(self, states, actions):
        return self.benv.step(states, actions, beep_u=self.loop.beep_u)

    def __getattr__(self, name):
        return getattr(self.benv, name)


class BeepReference(EnvReference):
    """The ORCA reference env replaying the compared steps with the
    program's beep draws."""

    def __init__(self, ref, drive, control=None):
        self.ref, self.drive, self.control = ref, drive, control
        orca_env = importlib.import_module("navbench.reference.env.orca_env")
        ref.types.setdefault("Segments", orca_env.orca_mod.Segments)
        self.cfg = ref.config.EnvConfig.from_dict(drive.config["env"])
        self.env = orca_env.OrcaNavEnv(self.cfg, drive.dev, seed=drive.seed)
        self.peds = True
        self.actor = drive.actor_mod.Check(self)
        self.splits = {}        # scene layout's rectangles -> its segments
        self.beep_u = self.beeps = None

    def own_segments(self, aabb):
        """The reference's split of each scene's rectangles [S, O, 4]."""
        parts = []
        for box in aabb:
            key = box.cpu().numpy().tobytes()
            if key not in self.splits:
                self.splits[key] = self.env.split(box)
            parts.append(self.splits[key])
        return self.ref.state.stack_trees(parts)

    def step(self, state, actions):
        env = self.env
        state = state._replace(obstacles=state.obstacles._replace(
            segs=self.own_segments(state.obstacles.aabb)))
        new, alive, self.beeps = env.advance_scenes(state, actions,
                                                    self.beep_u)
        new, obs = env.observe_scenes(new)
        out = env.finish_step(new, obs, alive, self.beeps)
        return out[0], out[1], out[3]

    def check_step(self, rd, rec: dict) -> None:
        self.beep_u = check.lower(rec["beep_u"], self.control)
        super().check_step(rd, rec)
        rd.put("beeps", rd.values.get("beeps", 0.0)
               + check.mismatch(rec["out_state"].robots.beep, self.beeps))


class Loop(EnvLoop):
    batch = True
    Reference = BeepReference

    def setup(self):
        super().setup()
        self.benv = _Beeping(self.benv, self)
        seed = int(np.random.default_rng([self.seed, 2]).integers(2 ** 62))
        self.beep_gen = torch.Generator(device=self.dev).manual_seed(seed)

    def step(self) -> None:
        self.beep_u = torch.rand((self.scenes, self.robots),
                                 generator=self.beep_gen, device=self.dev)
        super().step()
        if self.pending is not None:     # this step is compared
            self.pending["beep_u"] = self.beep_u
