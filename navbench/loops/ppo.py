"""The PPO loop: the program's trainer (``img_env_tpu_torch.train``)
training its policy over a ``BatchedNavEnv`` of ``scenes`` scenes, one
update a timed step, and its replay through the frozen reference.

The loop builds what ``train.run.train`` builds, from the trainer's own
functions: the world-of-one mesh (``make_mesh``), the batch env on it,
the policy (``init_policy`` from a generator seeded with the seed, then
``restore_params`` of the configuration's policy file where it names
one, ``pi_log_std`` forced to the traffic's ``log_std``) and
``make_train_step``'s ``train_step``.  The scenes reset from the first
``scenes`` episodes of the harness's pool, as ``EnvLoop.setup`` does.
One timed step is one ``train_step`` with the harness's ``Draws`` (the
traffic's ``actor``, ``actors/gaussian.py``: the rollout's standard
normals and each epoch's permutation; the next ``scenes`` layouts of the
pool in turn, of which each finished scene takes its own) and one host
read of the update's metrics, the trainer's learning-curve row.  The trainer runs unchanged: nothing of it is
written here.

``robots`` x ``scenes`` is T*N x S, the robot-steps of one update, so
``robot_steps_per_s`` reads what ``train.run`` prints as robot-steps/s.
In the span phase of a ``--trace 1`` run ``train_step`` is given
``timings=``, and its rollout, autoreset and update ms go into
``spans``; plain and profiled steps pass nothing and synchronise
nowhere else.

Besides the keys every loop reads (``drive.py``), a traffic file of this
loop holds ``actor``, ``scenes``, ``episode_pool``, ``autoreset`` (true:
the trainer's NeverStop redraw), ``reads`` (["metrics"]) and ``ppo``:
the ``PpoConfig`` fields it sets and ``log_std``.

A compared update keeps, through a thin recorder around the env that
``make_train_step`` is given, each env step's input state, commands and
outputs and each ``reset_local``'s scenes and outputs, with clones of
the train state (parameters and Adam's state) before and after; and,
through a forward pre-hook on the policy, the parameters of each
minibatch's gradient as the trainer passed them (a forward whose
parameters require a gradient), so that the reference takes each
minibatch's gradient where the program took it.  Once the
window has closed (``finish``), the trainer's own ``train_step.rollout``,
``train_step.forward`` and ``rollout_data`` are run again from the
update's recorded start for the numbers ``train_step`` keeps to itself:
the rollout's log-probabilities, values and rewards, the advantages and
the returns.  ``PpoReference`` then replays each compared update,
teacher-forced (``reference/train``).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from navbench import check, trainflops
from navbench.drive import Drive, tmap
from navbench.envloop import EnvReference, draw_episodes
from navbench.reference.models import policy as ref_policy
from navbench.reference.train import optim as ref_optim
from navbench.reference.train import ppo as ref_ppo

METRICS = ("loss", "pg_loss", "vf_loss", "entropy", "reward_mean",
           "arrive_rate", "collision_rate")


def _program(sut):
    """The trainer's names: the harness's program namespace where it has
    them (tests plant faults there), else the trainer's modules."""
    from img_env_tpu_torch.config import EnvConfig
    from img_env_tpu_torch.models import policy
    from img_env_tpu_torch.parallel.batched_env import BatchedNavEnv
    from img_env_tpu_torch.parallel.mesh import make_mesh
    from img_env_tpu_torch.train import ppo
    from img_env_tpu_torch.train.run import restore_params

    names = {"EnvConfig": EnvConfig, "BatchedNavEnv": BatchedNavEnv,
             "make_mesh": make_mesh, "PolicyConfig": policy.PolicyConfig,
             "init_policy": policy.init_policy,
             "restore_params": restore_params, "PpoConfig": ppo.PpoConfig,
             "make_train_step": ppo.make_train_step, "Draws": ppo.Draws,
             "obs_features": ppo.obs_features,
             "rollout_data": ppo.rollout_data}
    ns = type("Trainer", (), {})()
    for name, default in names.items():
        setattr(ns, name, getattr(sut, name, default))
    return ns


class _Copies:
    """Clones of tensor trees, each distinct tensor cloned once (a
    scene's maps are one tensor through the steps of a rollout)."""

    def __init__(self):
        self.memo = {}

    def __call__(self, tree):
        def one(x):
            hit = self.memo.get(id(x))
            if hit is None:
                hit = self.memo[id(x)] = (x, x.clone())
            return hit[1]
        return tmap(one, tree)


class _Recorder:
    """The program's batch env as ``make_train_step`` is given it: while
    ``rec`` is set, keeps each step's input state, commands and outputs,
    and each ``reset_local``'s scenes (by the layouts' places in
    ``layouts``) and outputs."""

    def __init__(self, benv):
        self.benv = benv
        self.rec = self.copy = None
        self.layouts = []

    def step(self, states, actions, *args, **kwargs):
        out = self.benv.step(states, actions, *args, **kwargs)
        if self.rec is not None:
            new, obs, _, done, _ = out
            c = self.copy
            self.rec["steps"].append({
                "state": c(states), "actions": c(actions),
                "out_state": c(new), "obs": c(obs), "done": c(done)})
        return out

    def reset_local(self, samples, *args, **kwargs):
        out = self.benv.reset_local(samples, *args, **kwargs)
        if self.rec is not None:
            where = {id(s): i for i, s in enumerate(self.layouts)}
            self.rec["resets"].append({
                "ids": [where[id(s)] for s in samples],
                "state": self.copy(out[0]), "obs": self.copy(out[1])})
        return out

    def __getattr__(self, name):
        return getattr(self.benv, name)


def _keep_grad_params(kept: list):
    """A forward pre-hook on the policy that appends to ``kept`` clones of
    the parameters of each forward that takes a gradient: under
    ``functional_call`` the module's parameters are the ones passed."""
    def hook(module, args):
        params = dict(module.named_parameters())
        if any(v.requires_grad for v in params.values()):
            kept.append({k: v.detach().clone() for k, v in params.items()})
    return hook


def adam_of(opt_state):
    """The Adam moments (``count``, ``mu``, ``nu``) inside an optimiser
    state tree."""
    if isinstance(opt_state, tuple):
        if getattr(opt_state, "_fields", None) == ("count", "mu", "nu"):
            return opt_state
        for part in opt_state:
            found = adam_of(part)
            if found is not None:
                return found
    return None


class Loop(Drive):
    batch = True
    resets = updates = 0    # since the warm-up: redrawn scenes, updates
    replay_s = None         # the reference's replay, seconds
    own_group = False       # whether free() ends the process group

    def setup(self):
        """Builds the trainer as ``train.run.train`` does, draws the
        episode pool, resets the scenes and keeps the warm start's
        parameters, the reset's state and observation (the start)."""
        tr, cfgd = self.traffic, self.config
        if list(tr["reads"]) != ["metrics"]:
            raise ValueError("the ppo loop reads the update's metrics")
        p = self.prog = _program(self.sut)
        self.env_cfg = p.EnvConfig.from_dict(cfgd["env"])
        ref_cfg = self.ref.config.EnvConfig.from_dict(cfgd["env"])
        settings = dict(tr["ppo"])
        log_std = float(settings.pop("log_std"))
        self.ppo_cfg = p.PpoConfig(autoreset=bool(tr["autoreset"]),
                                   **settings)
        self.settings = ref_ppo.Settings(**settings)
        self.scenes = int(tr["scenes"])
        self.n_rob = int(self.env_cfg.robot.total)
        self.robots = self.ppo_cfg.unroll * self.n_rob
        self.use_ped = self.env_cfg.ped_sim.total > 0
        t = time.perf_counter()
        self.episodes = draw_episodes(self.ref, ref_cfg, self.seed,
                                      max(int(tr["episode_pool"]),
                                          self.scenes))
        self.pool = [self.sut.ScenarioSample(*(x.to(self.dev) for x in s))
                     for s in self.episodes]
        self.harness_s = time.perf_counter() - t
        self.next_episode = 0

        # the world of one that make_mesh starts where no process group
        # is running is this loop's to end (``free``)
        self.own_group = not dist.is_initialized()
        mesh = p.make_mesh(device_type=self.dev.type)
        self.benv = p.BatchedNavEnv(self.env_cfg, self.dev, seed=self.seed,
                                    mesh=mesh)
        self.env = _Recorder(self.benv)
        self.gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        model, params = p.init_policy(
            self.gen, p.PolicyConfig.from_env_config(self.env_cfg),
            self.dev)
        if self.config.get("policy"):
            params = p.restore_params(self.config["policy"], params)
        params["pi_log_std"] = torch.full_like(params["pi_log_std"], log_std)
        self.start_params = {k: v.clone() for k, v in params.items()}
        self.model = model
        init_fn, self.train_step = p.make_train_step(self.env, model,
                                                     self.ppo_cfg)
        self.ts = init_fn(params)
        self.actor_mod = self.part("actors", tr["actor"])
        self.actor = self.actor_mod.Actor(self)
        self.states, self.obs = self.benv.reset(self._layouts()[0])
        self.start = (_Copies()(self.states), _Copies()(self.obs))

    def _layouts(self):
        """The next ``scenes`` layouts of the pool in turn and their
        episode numbers."""
        eps = [(self.next_episode + i) % len(self.pool)
               for i in range(self.scenes)]
        self.next_episode += self.scenes
        return [self.pool[e] for e in eps], eps

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One PPO update (``train_step``) with the harness's draws, then
        the host read of its metrics."""
        due = self.due()
        cfg = self.ppo_cfg
        eps, perms = self.actor.draws(cfg.unroll, self.scenes * self.n_rob,
                                      self.env_cfg.act_dim, cfg.epochs)
        layouts, episodes = self._layouts()
        draws = self.prog.Draws(eps, layouts, perms)
        self.env.layouts = layouts
        rec = hook = None
        if due:
            copy = _Copies()
            rec = {"k": self.k, "ts": copy(self.ts),
                   "states": copy(self.states), "obs": copy(self.obs),
                   "eps": eps, "perms": perms, "episodes": episodes,
                   "steps": [], "resets": [], "grad_params": []}
            self.env.rec, self.env.copy = rec, copy
            hook = self.model.register_forward_pre_hook(
                _keep_grad_params(rec["grad_params"]))
        timings = {} if self.mode == "spans" else None
        with self.region("train_step"):
            self.ts, self.states, self.obs, m = self.train_step(
                self.ts, self.states, self.obs, self.gen, draws=draws,
                timings=timings)
        with self.region("host_read"):
            row = torch.stack([torch.as_tensor(m[k]).float()
                               for k in METRICS]).cpu().tolist()
        self.resets += int(m["reset_scenes"])
        self.updates += 1
        if timings is not None:
            for name, s in timings.items():
                self.spans.setdefault(name, []).append(s * 1e3)
        if rec is not None:
            hook.remove()
            self.env.rec = self.env.copy = None
            copy = _Copies()
            rec.update(ts1=copy(self.ts), obs1=copy(self.obs),
                       metrics=dict(zip(METRICS, row)))
            self.checks.append(rec)
        self.k += 1

    def warm_up(self) -> None:
        super().warm_up()
        self.resets = self.updates = 0

    def finish(self) -> None:
        """The numbers ``train_step`` keeps to itself, for each compared
        update: the trainer's own unroll, last value and ``rollout_data``
        run again from the update's recorded start and draws."""
        p, cfg = self.prog, self.ppo_cfg
        for rec in self.checks:
            if "program" in rec:
                continue
            params = rec["ts"].params
            with torch.no_grad():
                _, _, traj = self.train_step.rollout(
                    params, rec["states"], rec["obs"], self.gen, rec["eps"])
                last = self.train_step.forward(
                    params, p.obs_features(rec["obs1"], self.use_ped))[-1]
                (_, _, logp, advs, returns), reward = p.rollout_data(
                    traj, last, cfg)
            rec["program"] = {
                "logp": logp, "advs": advs, "returns": returns,
                "reward": reward,
                "values": torch.stack([x[3] for x in traj]),
                "last_value": last}

    def free(self) -> None:
        for name in ("benv", "env", "model", "train_step", "ts", "states",
                     "obs", "actor", "pool"):
            self.__dict__.pop(name, None)
        if self.own_group and dist.is_initialized():
            dist.destroy_process_group()

    def log_lines(self):
        yield (f"# updates in the window: {self.updates}; scenes redrawn "
               f"by the autoreset: {self.resets} "
               f"({self.resets / max(self.updates, 1):.2f} an update)")
        if self.replay_s is not None:
            yield f"# replay of the compared updates: {self.replay_s} s"


class PpoReference(EnvReference):
    """The reference replaying each compared update, teacher-forced:
    every env step from the program's own state before it; the reference
    policy's mean, log-std and value on the program's observations with
    the update's parameters and ``eps``; the rewards, dones and the
    scenes it finds finished, redrawn; GAE; each minibatch's loss and
    gradient over the same permutations, at the parameters the program
    took it at; the clip and Adam from the program's Adam state.
    Compared numbers (``checks/<cell>.json``): the env's (the start's
    reset and every step and redraw), ``commands``, ``logp``, ``values``,
    ``rewards``, ``resets``, ``advantages``, ``loss``, ``moments``,
    ``params`` and ``warm_start``."""

    def __init__(self, ref, drive, control=None):
        super().__init__(ref, drive, control)
        cfg = self.cfg
        self.model = ref_policy.CrowdNavPolicy(
            ref_policy.PolicyConfig.from_env_config(cfg)).to(drive.dev)
        self.settings = drive.settings

    def update_flops(self) -> int:
        """One update's operations (``trainflops``)."""
        d = self.drive
        samples = d.robots * d.scenes
        return trainflops.update_flops(self.model.cfg, samples,
                                       self.settings.epochs,
                                       samples // self.settings.unroll)

    def step(self, state, actions):
        env = self.env
        new, alive, beeps = env.advance_scenes(state, actions)
        new, obs = env.observe_scenes(new)
        new, obs, _, done, _ = env.finish_step(new, obs, alive, beeps)
        return new, obs, done, alive

    def run(self) -> dict:
        ref, d, rd = self.ref, self.drive, check.Readings()
        t = time.perf_counter()
        with torch.no_grad(), check.precision(ref, self.control):
            state, obs = self.reset(list(range(d.scenes)))
            check.compare_env(rd, d.start[0], d.start[1], state, obs,
                              self.peds)
            rd.put("warm_start", self.warm_start_gap())
            for rec in d.checks:
                self.replay(rd, rec)
        d.replay_s = time.perf_counter() - t
        return rd.values

    def warm_start_gap(self) -> float:
        """Largest gap between the program's parameters before the first
        update and the reference's own: its load of the policy file, or
        its ``init_policy`` from the same seed; log-std forced."""
        d = self.drive
        if d.config.get("policy"):
            with np.load(d.config["policy"]) as z:
                want = ref_policy.policy_params_from_numpy(
                    {k: z[k] for k in z.files})
        else:
            _, want = ref_policy.init_policy(
                torch.Generator(device=d.dev).manual_seed(d.seed),
                self.model.cfg, d.dev)
        log_std = float(d.traffic["ppo"]["log_std"])
        want["pi_log_std"] = torch.full_like(want["pi_log_std"], log_std)
        got = d.start_params
        if set(got) != set(want):
            return float("inf")
        return max(check.gap(got[k], want[k].to(d.dev)) for k in want)

    # ------------------------------------------------------------------
    def replay(self, rd, rec: dict) -> None:
        ref, d, c, s = self.ref, self.drive, self.control, self.settings
        low = lambda x: check.lower(x, c)
        prog = rec["program"]
        params = low(dict(rec["ts"].params))
        n_act = d.env_cfg.act_dim
        feats, acts, logps, values, rewards, dones = [], [], [], [], [], []
        last_state = None
        for t, st in enumerate(rec["steps"]):
            obs_in = rec["obs"] if t == 0 else rec["steps"][t - 1]["obs"]
            f = ref_ppo.features(low(obs_in), self.peds)
            act, logp, command, value = self.actor.act(params, f,
                                                       low(rec["eps"][t]))
            rd.put("commands", check.gap(
                st["actions"][..., :n_act].reshape(command.shape), command))
            rd.put("logp", check.gap(prog["logp"].reshape(
                len(rec["steps"]), -1)[t], logp))
            rd.put("values", check.gap(prog["values"][t], value))
            state = low(check.to_ref(ref, st["state"]))
            new, obs, done, alive = self.step(state, low(st["actions"]))
            check.compare_env(rd, st["out_state"], st["obs"], new, obs,
                              self.peds)
            rd.put("codes", rd.values.get("codes", 0.0)
                   + check.mismatch(st["done"], done))
            reward = ref_ppo.clean_reward(obs, alive,
                                          float(self.cfg.ped_safety_space))
            rd.put("rewards", check.gap(prog["reward"][t],
                                        reward.reshape(-1)))
            feats.append(f)
            acts.append(act)
            logps.append(logp)
            values.append(value)
            rewards.append(reward.reshape(-1))
            dones.append(done.reshape(-1))
            last_state = new
        rd.put("rewards", abs(rec["metrics"]["reward_mean"]
                              - float(torch.stack(rewards).mean())))
        self.check_resets(rd, rec, last_state)

        last = ref_ppo.forward(self.model, params, ref_ppo.features(
            low(rec["obs1"]), self.peds))[2]
        rd.put("values", check.gap(prog["last_value"], last))
        values = torch.stack(values)
        advs = ref_ppo.gae(values, torch.stack(rewards) * s.reward_scale,
                           torch.stack(dones), last, s.gamma, s.lam)
        returns = advs + values
        rd.put("advantages", max(
            check.gap(prog["advs"], advs.reshape(-1)),
            check.gap(prog["returns"], returns.reshape(-1))))
        data = (tuple(None if f[0] is None else torch.cat(f)
                      for f in zip(*feats)),
                torch.cat(acts), torch.cat(logps), advs.reshape(-1),
                returns.reshape(-1))
        self.check_update(rd, rec, params, data)

    def check_resets(self, rd, rec, state) -> None:
        """The scenes the reference finds finished after the rollout
        against those the program redrew (``resets``: scenes in one set
        only), and the redraw of the scenes in both."""
        r = state.robots
        done_now = (torch.clamp(r.collision, 0, 1)
                    + r.arrive.to(torch.int32)) > 0
        finished = done_now.all(dim=-1) | (state.step
                                           >= int(self.cfg.time_max))
        want = torch.nonzero(finished.cpu()).flatten().tolist()
        if not self.drive.ppo_cfg.autoreset:
            want = []
        got = [i for call in rec["resets"] for i in call["ids"]]
        rd.put("resets", rd.values.get("resets", 0.0)
               + len(set(want) ^ set(got)))
        both = [i for i in got if i in set(want)]
        if not both:
            return
        rstate, robs = self.reset([rec["episodes"][i] for i in both])
        pos = {i: k for k, i in enumerate(got)}
        pick = torch.as_tensor([pos[i] for i in both], dtype=torch.int64,
                               device=self.drive.dev)
        cat = lambda *parts: torch.cat(parts)
        pstate = tmap(cat, *(call["state"] for call in rec["resets"]))
        pobs = tmap(cat, *(call["obs"] for call in rec["resets"]))
        sel = lambda x: x.index_select(0, pick)
        check.compare_env(rd, tmap(sel, pstate), tmap(sel, pobs), rstate,
                          robs, self.peds)

    def check_update(self, rd, rec, params, data) -> None:
        """Each minibatch's loss and gradient at the program's parameters
        before it, then the clip and Adam, from the program's state before
        the update; the loss means, Adam's moments (under the gradient's
        error model) and the parameters after it (the reference's own
        chain of Adam steps).  Taken at the reference's own parameters
        instead, a sample whose probability ratio lies within rounding of
        a clip edge (1 +- ``clip``) can be clipped on one side only, and
        the gradients then differ by that sample's whole term."""
        s, c = self.settings, self.control
        adam0 = adam_of(rec["ts"].opt_state)
        state = ref_optim.Adam(adam0.count, check.lower(dict(adam0.mu), c),
                               check.lower(dict(adam0.nu), c))
        tb = data[1].shape[0]
        n_mb = max(1, min(s.minibatches, tb))
        size = tb // n_mb
        p0, p = params, params
        kept = rec["grad_params"]
        if len(kept) != s.epochs * n_mb or any(
                set(at) != set(p0) for at in kept):
            for name in ("loss", "moments", "params"):
                rd.put(name, float("inf"))
            return
        tol_mu = {k: 0.0 for k in p0}
        tol_nu = {k: torch.zeros_like(v) for k, v in p0.items()}
        losses = []
        for e in range(s.epochs):
            idxs = rec["perms"][e][: size * n_mb].reshape(n_mb, size)
            for i, idx in enumerate(idxs):
                at = check.lower(kept[e * n_mb + i], c)
                mb = ref_ppo.take(data, idx)
                terms, grads = ref_ppo.loss_and_grads(self.model, at, mb, s)
                sums = ref_ppo.term_sums(self.model, at, mb, s)
                clipped, factor = ref_optim.clip_by_global_norm(
                    grads, s.max_grad_norm)
                f = float(factor)
                for k, g in clipped.items():
                    tol = f * (ref_ppo.GRAD_REL * float(sums[k].max())
                               + ref_ppo.GRAD_ABS)
                    tol_mu[k] = tol_mu[k] * ref_optim.B1 \
                        + (1 - ref_optim.B1) * tol
                    tol_nu[k] = tol_nu[k] * ref_optim.B2 + (
                        1 - ref_optim.B2) * (2 * g.abs() * tol + tol * tol)
                p, state = ref_optim.adam_step(p, clipped, state, s.lr)
                losses.append(terms)
        mean = torch.stack(losses).mean(0).tolist()
        m = rec["metrics"]
        rd.put("loss", max(abs(m[k] - v) for k, v in zip(
            ("loss", "pg_loss", "vf_loss", "entropy"), mean)))
        prog = adam_of(rec["ts1"].opt_state)
        ratio = 0.0 if int(prog.count) == int(state.count) else float("inf")
        for k in p0:
            ratio = max(ratio, check.gap(prog.mu[k], state.mu[k])
                        / tol_mu[k],
                        float(((prog.nu[k] - state.nu[k]).abs()
                               / (tol_nu[k] + 1e-30)).max()))
        rd.put("moments", ratio)
        p1 = rec["ts1"].params
        gap = sum(float((p1[k] - p[k]).double().square().sum()) for k in p)
        moved = sum(float((p[k] - p0[k]).double().square().sum())
                    for k in p)
        rd.put("params", (gap / moved) ** 0.5 if moved > 0 else
               (0.0 if gap == 0 else float("inf")))


Loop.Reference = PpoReference
