"""The port's host spans and counters (``img_env_tpu_torch.utils.trace``):
off by default and recording nothing then; the env step, the scene
batch's step and redraw, the MPC act, the policy and a PPO update giving
the same bits with tracing on and off; the span tree at the layer
boundaries; the redraw, crowd and ORCA counters, and the ORCA spans of the
``rvoscene`` and ``ervoscene`` crowds; the PPO update's spans and
counters; ``drain`` clearing.  A small config with SFM
peds on the CPU (the kernels' twins).  Imports nothing of JAX."""

import pytest
import torch

from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.env.nav_env import NavEnv
from img_env_tpu_torch.models.policy import (
    CrowdNavPolicy,
    PolicyConfig,
    init_policy,
    mean_action_fn,
)
from img_env_tpu_torch.mpc.controller import MpcController
from img_env_tpu_torch.mpc.mppi import MppiConfig
from img_env_tpu_torch.parallel import BatchedNavEnv
from img_env_tpu_torch.train.ppo import PpoConfig, make_train_step
from img_env_tpu_torch.utils import trace

torch.set_num_threads(1)

S = 3
BOX = [[1.0, 9.0, 1.0, 9.0]]
CFG = {
    "robot": {"total": 2, "begin_poses_type": ["range"],
              "begin_poses": BOX, "target_poses_type": ["range"],
              "target_poses": BOX},
    "object": {"total": 3, "shape": ["rectangle"],
               "size_range": [[0.1, 0.4, 0.1, 0.4]],
               "poses_type": ["range"], "poses": [[2.0, 8.0, 2.0, 8.0]]},
    "ped_sim": {"total": 2, "type": "pedscene", "max_speed": [0.5],
                "shape": ["leg"], "size": [[0.0, 0.1, 0.1]],
                "begin_poses_type": ["range"], "begin_poses": BOX,
                "target_poses_type": ["range"], "target_poses": BOX},
    "global_map": {"resolution": 0.1, "map_file": "room_10.png"},
    "view_map": {"resolution": 0.05, "width": 3, "height": 3},
    "range_total": 64,
    "max_ped": 3,
}
ACT = torch.tensor([[0.4, 0.3, 0.0], [0.5, -0.2, 1.0]])
MPPI = MppiConfig(horizon=3, samples=8)


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and nothing held."""
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def cfg():
    return EnvConfig.from_dict(CFG)


def run_env_step():
    env = NavEnv(cfg(), "cpu", seed=5)
    state, _ = env.reset()
    return env.step(state, ACT)[:4]


def run_batch_step():
    """A batch step, then two scenes redrawn through ``reset_local``: the
    autoreset's step, redraw and observation."""
    benv = BatchedNavEnv(cfg(), "cpu", seed=5)
    states, _ = benv.reset(S)
    acts = ACT.expand(S, -1, -1)
    states, obs, reward, done, _ = benv.step(states, acts)
    redrawn = benv.reset_local([benv.core.sample_scenario()
                                for _ in range(2)])
    return states, obs, reward, done, redrawn


def run_act():
    benv = BatchedNavEnv(cfg(), "cpu", seed=5)
    states, _ = benv.reset(S)
    ctl = MpcController(benv.core, MPPI, seed=7)
    return ctl.act_scenes(states, ctl.init_scenes_state(S))


def run_policy():
    benv = BatchedNavEnv(cfg(), "cpu", seed=5)
    _, obs = benv.reset(S)
    torch.manual_seed(0)
    policy = CrowdNavPolicy(PolicyConfig.from_env_config(cfg())).eval()
    return mean_action_fn(policy, cfg())(None, obs)


PPO = PpoConfig(unroll=3, epochs=2, minibatches=2)


def run_train_step():
    """One PPO update of S scenes whose time limit (2 steps) ends within
    the unroll, so that the autoreset redraws every scene."""
    benv = BatchedNavEnv(EnvConfig.from_dict(dict(CFG, time_max=2)), "cpu",
                         seed=5)
    gen = torch.Generator().manual_seed(1)
    model, params = init_policy(gen, PolicyConfig.from_env_config(benv.cfg),
                                "cpu")
    init_fn, train_step = make_train_step(benv, model, PPO)
    states, obs = benv.reset(S)
    return train_step(init_fn(params), states, obs, gen)


RUNS = {"env_step": run_env_step, "batch_step_and_redraw": run_batch_step,
        "act_scenes": run_act, "policy": run_policy,
        "train_step": run_train_step}


def leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return []


def tree_of(spans):
    """{name: set of parent names} of drained spans."""
    out = {}
    for name, parent, _, _ in spans:
        out.setdefault(name, set()).add(
            spans[parent][0] if parent >= 0 else None)
    return out


def test_off_by_default_records_nothing():
    for run in RUNS.values():
        run()
    trace.count("reset.scenes", 3)
    assert trace.drain() == ([], {})


def test_off_returns_one_shared_object():
    assert trace.span("env.step") is trace.span("mpc.act")


@pytest.mark.parametrize("name", sorted(RUNS))
def test_same_bits_with_tracing_on_and_off(name):
    off = leaves(RUNS[name]())
    trace.enable()
    on = leaves(RUNS[name]())
    trace.disable()
    spans, _ = trace.drain()
    assert spans and len(on) == len(off) > 0
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_env_span_tree():
    trace.enable()
    run_env_step()
    spans, counts = trace.drain()
    tree = tree_of(spans)
    assert tree["setup.statics"] == {None}
    assert tree["env.step"] == {None}
    assert tree["env.advance"] == {"env.step"}
    assert tree["env.crowd"] == {"env.advance"}
    assert tree["env.dynamics"] == {"env.advance"}
    # the reset observes outside any step; the step's observation inside
    assert tree["env.observe"] == {None, "env.step"}
    for name in ("env.raster", "env.sensor", "env.peds"):
        assert tree[name] == {"env.observe"}
    assert counts == {"crowd.scenes": 1}      # the one scene's crowd


def test_batch_span_tree_and_redraw_counter():
    trace.enable()
    run_batch_step()
    spans, counts = trace.drain()
    tree = tree_of(spans)
    assert tree["env.step"] == {None}       # BatchedNavEnv.step
    assert tree["env.advance"] == {"env.step"}
    assert tree["env.crowd"] == {"env.advance"}
    assert tree["batch.reset_local"] == {None}
    assert tree["reset.states"] == {"batch.reset_local"}
    assert tree["env.observe"] == {"batch.reset_local", "env.step"}
    names = [s[0] for s in spans]
    assert names.count("batch.reset_local") == 2    # reset(S), then 2 redrawn
    assert counts == {"reset.scenes": S + 2, "crowd.scenes": S}


def test_batch_without_peds_has_no_crowd_span():
    d = dict(CFG, ped_sim={"total": 0, "type": ""})
    benv = BatchedNavEnv(EnvConfig.from_dict(d), "cpu", seed=5)
    states, _ = benv.reset(2)
    trace.enable()
    benv.step(states, ACT.expand(2, -1, -1))
    names = {s[0] for s in trace.drain()[0]}
    assert {"env.step", "env.advance", "env.dynamics", "env.observe",
            "env.raster", "env.sensor"} <= names
    assert not names & {"env.crowd", "env.peds"}


@pytest.mark.parametrize("scene,on,want", [
    ("pedscene", True, {"crowd.scenes": S}),
    ("rvoscene", True, {"crowd.scenes": S, "orca.agents": 2 * S}),
    ("pedscene", False, {}),
    ("rvoscene", False, {})], ids=["pedscene", "rvoscene", "pedscene-off",
                                   "rvoscene-off"])
def test_crowd_engagement_counters(scene, on, want):
    """One batch step of S scenes counts its scenes once in
    ``crowd.scenes``: the crowd steps them at once, SFM and ORCA alike
    (ORCA with ``orca.agents``, the peds it solves); nothing with tracing
    off."""
    d = dict(CFG, ped_sim=dict(CFG["ped_sim"], type=scene))
    benv = BatchedNavEnv(EnvConfig.from_dict(d), "cpu", seed=5)
    states, _ = benv.reset(S)
    if on:
        trace.enable()
    benv.step(states, ACT.expand(S, -1, -1))
    spans, counts = trace.drain()
    assert counts == want
    assert bool(spans) == on


def run_orca_batch(scene):
    """S scenes of an ORCA crowd reset (the split) and stepped once, every
    beeping robot answered (``ervoscene``: the evacuation term)."""
    d = dict(CFG, ped_sim=dict(CFG["ped_sim"], type=scene))
    benv = BatchedNavEnv(EnvConfig.from_dict(d), "cpu", seed=5)
    states, _ = benv.reset(S)
    out = benv.step(states, ACT.expand(S, -1, -1),
                    beep_u=torch.zeros(S, ACT.shape[0]))
    return states, out[:4]


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("scene", ["rvoscene", "ervoscene"])
def test_orca_spans_and_counters(scene, on):
    """``reset.split`` around each reset scene's kd-tree split, one
    ``crowd.orca`` span a step inside ``env.crowd`` (every scene solved in
    one call) holding ``orca.lines`` and ``orca.solve``; counters
    ``orca.segments`` (the split's segments) and ``orca.agents`` (+M a
    scene solved); the same bits on and off."""
    off = leaves(run_orca_batch(scene))
    if on:
        trace.enable()
    states, out = run_orca_batch(scene)
    trace.disable()
    spans, counts = trace.drain()
    got = leaves((states, out))
    assert len(got) == len(off) > 0
    for a, b in zip(got, off):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if not on:
        assert (spans, counts) == ([], {})
        return
    tree = tree_of(spans)
    assert tree["reset.split"] == {"reset.states"}
    assert tree["crowd.orca"] == {"env.crowd"}
    assert tree["orca.lines"] == {"crowd.orca"}
    assert tree["orca.solve"] == {"crowd.orca"}
    names = [s[0] for s in spans]
    assert names.count("reset.split") == S
    for name in ("crowd.orca", "orca.lines", "orca.solve"):
        assert names.count(name) == 1
    segments = int(states.obstacles.segs.valid.sum())
    assert segments >= 4 * 3 * S        # the 3 rectangles' edges, split
    assert counts == {"reset.scenes": S, "orca.segments": segments,
                      "crowd.scenes": S, "orca.agents": 2 * S}


def test_ppo_span_tree_and_counters():
    """``ppo.rollout`` holds each step's ``ppo.sample`` and the env's
    spans, ``ppo.autoreset`` the redraw, ``ppo.update`` the GAE and each
    minibatch's ``ppo.grads`` and ``ppo.optim``; the counters read T*S*N
    samples, epochs x minibatches and the metrics' ``reset_scenes``."""
    trace.enable()
    *_, metrics = run_train_step()
    spans, counts = trace.drain()
    tree = tree_of(spans)
    for name in ("ppo.rollout", "ppo.autoreset", "ppo.update"):
        assert tree[name] == {None}
    assert tree["ppo.sample"] == {"ppo.rollout"}
    assert tree["env.step"] == {"ppo.rollout"}
    assert tree["batch.reset_local"] == {None, "ppo.autoreset"}
    for name in ("ppo.gae", "ppo.grads", "ppo.optim"):
        assert tree[name] == {"ppo.update"}
    names = [s[0] for s in spans]
    assert names.count("ppo.sample") == names.count("env.step") == PPO.unroll
    n_mb = PPO.epochs * PPO.minibatches
    assert names.count("ppo.grads") == names.count("ppo.optim") == n_mb
    assert names.count("ppo.gae") == 1
    n_rob = CFG["robot"]["total"]
    assert metrics["reset_scenes"] == S
    assert counts["ppo.samples"] == PPO.unroll * S * n_rob
    assert counts["ppo.minibatches"] == n_mb
    assert counts["ppo.reset_scenes"] == metrics["reset_scenes"]
    assert counts["reset.scenes"] == 2 * S      # the first reset, the redraw


def test_mpc_span_tree():
    trace.enable()
    run_act()
    spans, _ = trace.drain()
    tree = tree_of(spans)
    assert tree["mpc.act"] == {None}
    assert tree["mpc.predict"] == {"mpc.act"}
    assert tree["mpc.solve"] == {"mpc.act"}
    for name in ("mpc.neighbours", "mpc.edt", "mpc.rollout"):
        assert tree[name] == {"mpc.solve"}
    assert [s[0] for s in spans].count("mpc.act") == 1


def test_ilqr_solve_span():
    env = NavEnv(cfg(), "cpu", seed=5)
    state, _ = env.reset()
    ctl = MpcController(env, MPPI, method="ilqr")
    trace.enable()
    ctl.act(state, ctl.init_state())
    tree = tree_of(trace.drain()[0])
    assert tree == {"mpc.act": {None}, "mpc.predict": {"mpc.act"},
                    "mpc.solve": {"mpc.act"}}


def test_one_scene_act_and_policy_spans():
    env = NavEnv(cfg(), "cpu", seed=5)
    state, _ = env.reset()
    ctl = MpcController(env, MPPI, seed=7)
    trace.enable()
    ctl.act(state, ctl.init_state())
    tree = tree_of(trace.drain()[0])
    assert tree["mpc.act"] == {None} and tree["mpc.rollout"] == {"mpc.solve"}
    run_policy()
    tree = tree_of(trace.drain()[0])
    assert tree["policy.forward"] == {None}


@pytest.mark.parametrize("head", ["orca", "sfm", "cv"])
def test_prediction_head_counters(head):
    """A one-scene act counts each crowd-model step of its head inside
    ``mpc.predict``: ``predict.solves`` H and ``predict.agents`` H·M with
    'orca' and 'sfm'; 'cv' steps no crowd model and counts nothing."""
    env = NavEnv(cfg(), "cpu", seed=5)
    state, _ = env.reset()
    ctl = MpcController(env, MPPI, ped_prediction=head, seed=7)
    trace.enable()
    ctl.act(state, ctl.init_state())
    spans, counts = trace.drain()
    assert tree_of(spans)["mpc.predict"] == {"mpc.act"}
    predict = {k: v for k, v in counts.items() if k.startswith("predict.")}
    m = CFG["ped_sim"]["total"]
    want = ({} if head == "cv" else
            {"predict.solves": MPPI.horizon,
             "predict.agents": MPPI.horizon * m})
    assert predict == want


def test_spans_nest_in_time_and_self_time():
    trace.enable()
    run_batch_step()
    spans, _ = trace.drain()
    for name, parent, start, end in spans:
        assert start <= end
        if parent >= 0:
            p = spans[parent]
            assert p[2] <= start and end <= p[3], (name, p[0])
    own = trace.self_ns(spans)
    for (name, _, start, end), o in zip(spans, own):
        assert 0 <= o <= end - start, name
    # one span with two children: the self time is what they leave
    fake = [("a", -1, 0, 100), ("b", 0, 10, 30), ("c", 0, 40, 90),
            ("d", 2, 50, 60)]
    assert trace.self_ns(fake) == [30, 20, 40, 10]


def test_drain_clears_and_disable_stops():
    trace.enable()
    run_env_step()
    trace.count("reset.scenes", 2)
    spans, counts = trace.drain()
    assert spans and counts == {"reset.scenes": 2, "crowd.scenes": 1}
    assert trace.drain() == ([], {})
    trace.disable()
    run_env_step()
    assert trace.drain() == ([], {})


def test_drain_between_open_spans_keeps_parents_consistent():
    trace.enable()
    with trace.span("outer"):
        with trace.span("inner"):
            pass
        with trace.span("open"):
            spans, _ = trace.drain()
    assert [s[:2] for s in spans] == [("inner", -1)]
    assert trace.drain() == ([], {})
