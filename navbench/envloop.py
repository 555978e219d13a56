"""The closed control loop over the program's env, shared by the
``control`` loop (one ``NavEnv``: every robot of one scene) and the
``batch`` loop (one ``BatchedNavEnv`` of ``scenes`` scenes), and its
replay through the frozen reference.

Besides the keys every loop reads (``drive.py``), a traffic file of these
loops holds:

* ``actor``: the module that chooses the commands,
  ``navbench/actors/<actor>.py`` (``Actor`` on the program's side,
  ``Check`` on the reference's), with its own keys (``mppi``, ...);
* ``reads``: what the host reads back every step, among ``commands``
  (after the actor, as a fleet controller sending them) and ``codes``
  (the done codes, after the env step); an empty list reads nothing, and
  the window then ends on a synchronisation;
* ``scenes`` (batch): the scenes of the batch;
* ``autoreset`` (batch, needs ``codes``): a finished scene (every robot
  done, or ``time_max`` + 1 steps) is redrawn with the next episode of a
  pool of ``episode_pool`` episodes through ``reset_local``.

Episode layouts are the harness's own input: drawn on the host by the
reference's sampler from the seed, and handed to both sides.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from navbench import check
from navbench.drive import Drive, clone, tmap

READS = ("commands", "codes")


def draw_episodes(ref, env_cfg, seed: int, count: int):
    """``count`` episode layouts drawn on the host by the reference's
    sampler, episode e from a generator seeded with (seed, e)."""
    spec = ref.sampler.SamplerSpec.from_config(env_cfg)
    base = (int(seed) * 1_000_003) % (2 ** 62)
    return [ref.sampler.sample_scenario_retry(
        spec, torch.Generator().manual_seed(base + e), "cpu")
        for e in range(count)]


class EnvLoop(Drive):
    """Actor, host reads, env step, host reads, redraws: one control
    step.  ``batch``: a ``BatchedNavEnv`` (else one ``NavEnv``)."""

    batch = False

    # ------------------------------------------------------------------
    def setup(self):
        """Builds the env and the actor, draws the episodes, resets and
        keeps the reset's state and observation for the check (the
        start)."""
        sut, tr, cfgd = self.sut, self.traffic, self.config
        self.reads = tuple(tr["reads"])
        bad = set(self.reads) - set(READS)
        if bad:
            raise ValueError(f"unknown reads {sorted(bad)}")
        self.autoreset = bool(self.batch and tr.get("autoreset"))
        if self.autoreset and "codes" not in self.reads:
            raise ValueError("autoreset needs the codes read every step")
        self.env_cfg = sut.EnvConfig.from_dict(cfgd["env"])
        ref_cfg = self.ref.config.EnvConfig.from_dict(cfgd["env"])
        self.scenes = int(tr["scenes"]) if self.batch else 1
        self.robots = int(self.env_cfg.robot.total)
        self.max_steps = int(self.env_cfg.time_max) + 1
        pool = int(tr.get("episode_pool", self.scenes))
        t = time.perf_counter()
        self.episodes = draw_episodes(self.ref, ref_cfg, self.seed,
                                      max(pool, self.scenes))
        self.harness_s = time.perf_counter() - t
        self.next_episode = self.scenes
        self.gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        if self.batch:
            self.benv = sut.BatchedNavEnv(self.env_cfg, self.dev,
                                          seed=self.seed)
            self.core = self.benv.core
        else:
            self.core = sut.NavEnv(self.env_cfg, self.dev, seed=self.seed)
        self.actor_mod = self.part("actors", tr["actor"])
        self.actor = self.actor_mod.Actor(self)
        first = [self.to_sut_sample(s) for s in self.episodes[:self.scenes]]
        if self.batch:
            self.states, self.obs = self.benv.reset(first)
            self.ep_steps = np.zeros(self.scenes, np.int64)
        else:
            self.states, self.obs = self.core.reset(first[0])
        self.actor.reset()
        self.start = (clone(self.states), clone(self.obs))
        if self.autoreset:
            # the autoreset's shapes: one scene redrawn
            self.benv.reset_local([first[0]])

    def to_sut_sample(self, s):
        return self.sut.ScenarioSample(*(x.to(self.dev) for x in s))

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One control step: the actor, the host read of the commands
        (where the traffic reads them), the env step, the host read of the
        done codes (where it reads them) and, for a batch with autoreset,
        the redraw of the finished scenes."""
        due = self.due()
        actions, aux = self.actor.act(self.pending is not None)
        self._close(actions, aux)
        if "commands" in self.reads:
            with self.region("host_read"):
                actions.cpu()
        rec = None
        if due:
            rec = {"k": self.k, "state": clone(self.states),
                   "actions": actions.clone()}
        with self.region("env_step"):
            if self.batch:
                self.states, self.obs, _, done, _ = self.benv.step(
                    self.states, actions)
            else:
                self.states, self.obs, _, done, _ = self.core.step(
                    self.states, actions)
        done_h = None
        if "codes" in self.reads:
            with self.region("host_read"):
                done_h = done.cpu().numpy()
        if rec is not None:
            rec.update(out_state=clone(self.states), out_obs=clone(self.obs),
                       done=done.clone(), resets=[])
        if self.autoreset:
            self.ep_steps += 1
            finished = ((done_h.reshape(self.scenes, -1) != 0).all(-1)
                        | (self.ep_steps >= self.max_steps))
            ids = np.nonzero(finished)[0].tolist()
            if ids:
                with self.region("reset_local"):
                    self._redraw(ids, rec)
        if rec is not None:
            self.pending = rec
        self.k += 1

    def _redraw(self, ids, rec) -> None:
        eps = []
        for _ in ids:
            eps.append(self.next_episode % len(self.episodes))
            self.next_episode += 1
        samples = [self.to_sut_sample(self.episodes[e]) for e in eps]
        rstates, robs = self.benv.reset_local(samples)
        idx = torch.as_tensor(ids, dtype=torch.int64, device=self.dev)
        put = lambda old, new: old.index_copy(0, idx, new)
        self.states = tmap(put, self.states, rstates)
        self.obs = tmap(put, self.obs, robs)
        self.actor.redraw(idx)
        self.ep_steps[ids] = 0
        if rec is not None:
            rec["resets"] = list(zip(ids, eps))
            rec["reset_state"] = clone(rstates)
            rec["reset_obs"] = clone(robs)

    def _close(self, actions, aux) -> None:
        """Completes a compared step with the next actor call's inputs and
        outputs."""
        if self.pending is not None:
            self.pending["actor"] = {"actions": actions.clone(),
                                     **{k: clone(v) for k, v in aux.items()}}
            self.checks.append(self.pending)
            self.pending = None

    def finish(self) -> None:
        """Closes a compared step still waiting for the next actor call."""
        if self.pending is not None:
            self._close(*self.actor.act(True))

    def free(self) -> None:
        for name in ("benv", "core", "actor", "states", "obs"):
            self.__dict__.pop(name, None)

    def log_lines(self):
        if self.autoreset:
            yield (f"# scenes redrawn since set-up: "
                   f"{self.next_episode - self.scenes}")


class EnvReference:
    """The reference env (and the actor's reference side) of one cell:
    replays the start and every compared step from the program's own
    state, commands and draws."""

    def __init__(self, ref, drive, control=None):
        self.ref, self.drive, self.control = ref, drive, control
        self.cfg = ref.config.EnvConfig.from_dict(drive.config["env"])
        self.env = ref.nav_env.NavEnv(self.cfg, drive.dev, seed=drive.seed)
        self.peds = self.cfg.ped_sim.total > 0
        self.actor = drive.actor_mod.Check(self)

    def sample(self, e):
        s = self.drive.episodes[e]
        return type(s)(*(x.to(self.drive.dev) for x in s))

    def reset(self, episodes):
        """The reference's reset of these episodes (a scene axis in a
        batch)."""
        env = self.env
        if not self.drive.batch:
            return env.reset(self.sample(episodes[0]))
        states = self.ref.state.stack_trees(
            [env.reset_state_fn(self.sample(e)) for e in episodes])
        return env.observe_scenes(states)

    def step(self, state, actions):
        env = self.env
        if not self.drive.batch:
            out = env.step_fn(state, actions)
        else:
            new, alive, beeps = env.advance_scenes(state, actions)
            new, obs = env.observe_scenes(new)
            out = env.finish_step(new, obs, alive, beeps)
        return out[0], out[1], out[3]

    def run(self) -> dict:
        """{number: largest reading} over the start and every compared
        step."""
        ref, d, rd = self.ref, self.drive, check.Readings()
        with torch.no_grad(), check.precision(ref, self.control):
            state, obs = self.reset(list(range(d.scenes)))
            check.compare_env(rd, d.start[0], d.start[1], state, obs,
                              self.peds)
            for rec in d.checks:
                self.check_step(rd, rec)
        return rd.values

    def check_step(self, rd, rec: dict) -> None:
        ref, d, c = self.ref, self.drive, self.control
        state = check.lower(check.to_ref(ref, rec["state"]), c)
        new, obs, done = self.step(state, check.lower(rec["actions"], c))
        check.compare_env(rd, rec["out_state"], rec["out_obs"], new, obs,
                          self.peds)
        rd.put("codes", rd.values["codes"]
               + check.mismatch(rec["done"], done))
        if rec["resets"]:
            ids = [i for i, _ in rec["resets"]]
            rstate, robs = self.reset([e for _, e in rec["resets"]])
            check.compare_env(rd, rec["reset_state"], rec["reset_obs"],
                              rstate, robs, self.peds)
            idx = torch.as_tensor(ids, dtype=torch.int64, device=d.dev)
            put = lambda old, part: old.index_copy(0, idx, part)
            new, obs = tmap(put, new, rstate), tmap(put, obs, robs)
        if rec.get("actor") is not None:
            self.actor.compare(rd, new, obs, rec["actor"])
