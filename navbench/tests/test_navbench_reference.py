"""The frozen reference against the program at tiny sizes on the CPU: every
cell reads 0 on every compared number; the bf16 control, a step that
returns its state unchanged, half of the robots or scenes left out and an
answer altered where it is produced each make ``correct`` false, and so
does an answer altered only once the window has run a while (the late
compared step).  (No cell spans chips, so no exchange between chips can
be left out.)"""

import json

import pytest
import torch

import tiny
from navbench import check, control, run
from navbench.drive import tmap

CELLS = list(tiny.CELLS)


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    d = tmp_path_factory.mktemp("checkout")
    return str(d), tiny.make_checkout(str(d))


@pytest.mark.parametrize("cell", CELLS)
def test_program_equals_reference(checkout, cell):
    d, bench = checkout
    res = run.run_cell(bench, cell, 2 ** 31 + 17, 0.5, False, "cpu", d)
    assert res["correct"] is True
    assert all(c["value"] == 0.0 for c in res["checks"].values()), \
        res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_control_fails(checkout, cell):
    d, bench = checkout
    limits = check.load_limits(f"{tiny.HERE}/checks/{cell}.json")
    got = control.readings(bench, cell, 21, ["bf16"], "cpu", d)
    assert all(v == 0.0 for v in got["float32"].values())
    ok, _ = check.judge(got["bf16"], limits)
    assert not ok


def _faulty(kind: str):
    """The program with one fault planted in its timed path."""
    sut = run.program()

    def half(old, new):
        """The second half of the robots (one scene) or scenes (a batch)
        left as they were."""
        def f(o, n):
            if o.dim() == 0 or o.shape != n.shape:
                return n
            k = o.shape[0] // 2
            return torch.cat([n[:k], o[k:]])
        return tmap(f, old, new)

    def late(obs):
        """Lasers altered from the 8th env step on: after the early
        compared steps (warm-up 1, within 3)."""
        calls[0] += 1
        if calls[0] < 8:
            return obs
        obs = obs._replace(lasers=obs.lasers.clone())
        obs.lasers.view(-1)[0] += 0.01
        return obs

    calls = [0]

    class Env(sut.NavEnv):
        def step(self, state, actions):
            new, obs, r, done, info = super().step(state, actions)
            if kind == "late_altered":
                obs = late(obs)
            if kind == "state_unchanged":
                new = state
            elif kind == "half_left_out":
                new = state._replace(robots=half(state.robots, new.robots))
            elif kind == "altered_answer":
                obs = obs._replace(lasers=obs.lasers.clone())
                obs.lasers[0, 0] += 0.01
            return new, obs, r, done, info

    class BEnv(sut.BatchedNavEnv):
        def step(self, states, actions, beep_u=None):
            new, obs, r, done, info = super().step(states, actions, beep_u)
            if kind == "late_altered":
                obs = late(obs)
            if kind == "state_unchanged":
                new = states
            elif kind == "half_left_out":
                new, obs = half(states, new), obs
            return new, obs, r, done, info

    class Ctl(sut.MpcController):
        def act(self, state, mpc_state, noise=None):
            a, ms, c = super().act(state, mpc_state, noise)
            if kind == "altered_answer":
                a = a.clone()
                a[0, 0] += 1e-3
            return a, ms, c

        def act_scenes(self, states, mpc_state, noise=None):
            a, ms, c = super().act_scenes(states, mpc_state, noise)
            if kind == "altered_answer":
                a = a.clone()
                a[0, 0, 1] += 1e-3
            return a, ms, c

    plain_mean_action_fn = sut.mean_action_fn

    def mean_action_fn(policy, cfg):
        fn = plain_mean_action_fn(policy, cfg)

        def g(gen, obs):
            a = fn(gen, obs)
            if kind == "altered_answer":
                a = a.clone()
                a[0, 0, 1] += 1e-3
            return a
        return g

    sut.NavEnv, sut.BatchedNavEnv, sut.MpcController = Env, BEnv, Ctl
    sut.mean_action_fn = mean_action_fn
    return sut


FAULTS = [("bench200.mppi", "state_unchanged"),
          ("bench200.mppi", "half_left_out"),
          ("bench200.mppi", "altered_answer"),
          ("bench200.step", "altered_answer"),
          ("stage5.eval50", "state_unchanged"),
          ("stage5.eval50", "half_left_out"),
          ("stage5.eval50", "altered_answer"),
          ("stage5.mppi50", "altered_answer")]


@pytest.mark.parametrize("cell,kind", FAULTS)
def test_fault_makes_correct_false(checkout, cell, kind):
    """A whole run, the card's look skipped, with the fault underneath."""
    d, bench = checkout
    res = run.run_cell(bench, cell, 31, 0.5, False, "cpu", d,
                       sut=_faulty(kind))
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", ["bench200.step", "stage5.eval50"])
def test_late_step_catches_a_late_fault(checkout, cell):
    """One compared step starts in the window's second half; a fault that
    begins only after the early compared steps makes ``correct`` false,
    and the same run without the fault is correct."""
    d, bench = checkout
    within = tiny.tiny_traffic(tiny.CELLS[cell][1])["check"]["within"]
    for kind, want in (("late_altered", False), ("none", True)):
        log = []
        res = run.run_cell(bench, cell, 41, 1.0, False, "cpu", d,
                           sut=_faulty(kind), log=log)
        line = next(x for x in log if x.startswith("# compared steps:"))
        steps = json.loads(line.split(":", 1)[1])
        assert max(steps) >= max(8, res["attempted"] // 3), (steps, res)
        assert steps[:-1] == sorted(s for s in steps if s < within)
        assert res["correct"] is want, res["checks"]
