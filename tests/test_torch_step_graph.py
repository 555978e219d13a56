"""The graphed env step (``img_env_tpu_torch.env.step_graph``) on the CPU:
the step stays eager there and gives the bits of the advance, observe and
finish pipeline it wraps, and no graph counter moves; the key separates
what the step's Python code branches on (a None leaf, shapes, the beep
draw, grad mode); the inputs are copied only when they change; and the
outputs a replay hands back (views of the arena's clone, the caller's own
tensors where the step passes an input through) equal the eager step's
bit for bit and outlive the next replay.  The capture and replay
themselves run on the card (``tests/test_torch_card_graph.py``).  Small
configs of ``card_common.py``, the kernels' twins; imports nothing of
JAX."""

import pytest
import torch

import card_common as cc
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.core.state import map_tree
from img_env_tpu_torch.env import step_graph as sg
from img_env_tpu_torch.env.nav_env import NavEnv
from img_env_tpu_torch.parallel import BatchedNavEnv
from img_env_tpu_torch.utils import trace

torch.set_num_threads(1)

S = 3
CONFIGS = {"sfm": cc.SMALL_PED, "orca": cc.SMALL_RVO, "no peds": cc.SMALL}
GRAPH_COUNTERS = ("env.graph_captures", "env.graph_replays",
                  "env.eager_steps", "env.graph_failures")


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _actions(cfg: EnvConfig, scenes: int):
    n = cfg.robot.total
    act = torch.tensor([[0.4, 0.3, 0.0], [0.5, -0.2, 1.0]])
    return act.repeat(n, 1)[:n].expand(scenes, n, 3).contiguous()


def _assert_trees_equal(got, want):
    g, w = [], []
    assert sg.flatten(got, g) == sg.flatten(want, w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cpu_batch_step_is_eager(name):
    """``BatchedNavEnv.step`` on the CPU: three steps equal advance,
    observe and finish run by hand on the same states, bit for bit (the
    beep draws from generators of one seed); no graph is kept and no
    graph counter moves."""
    cfg = EnvConfig.from_dict(CONFIGS[name])
    env, ref = (BatchedNavEnv(cfg, "cpu", seed=5) for _ in range(2))
    states, _ = env.reset(S)
    ref.reset(S)
    act = _actions(cfg, S)
    for _ in range(3):
        trace.enable()
        out = env.step(states, act)
        trace.disable()
        core = ref.core
        new, alive, beeps = core.advance_scenes(states, act)
        new, obs = core.observe_scenes(new)
        _assert_trees_equal(out, core.finish_step(new, obs, alive, beeps))
        states = out[0]
    _, counts = trace.drain()
    assert not set(GRAPH_COUNTERS) & set(counts)
    assert counts.get("crowd.scenes", 0) == (3 * S if cfg.ped_sim.total
                                              else 0)
    assert not env.core._graphs.graphs


def test_cpu_single_step_is_eager():
    """``NavEnv.step_fn`` on the CPU equals today's single-scene pipeline
    (``advance_fn``, ``_observe``, ``finish_step``) bit for bit, with and
    without ``beep_u``, and moves no graph counter."""
    cfg = EnvConfig.from_dict(cc.SMALL_ERVO)
    env, ref = NavEnv(cfg, "cpu", seed=2), NavEnv(cfg, "cpu", seed=2)
    state, _ = env.reset()
    ref.reset()
    act = _actions(cfg, 1)[0]
    u = torch.rand(cfg.robot.total,
                   generator=torch.Generator().manual_seed(1))
    for beep_u in (None, u, None):
        trace.enable()
        out = env.step_fn(state, act, beep_u)
        trace.disable()
        new, alive, beeps = ref.advance_fn(state, act, beep_u)
        new, obs = ref._observe(new)
        _assert_trees_equal(out, ref.finish_step(new, obs, alive, beeps))
        state = out[0]
    _, counts = trace.drain()
    assert not set(GRAPH_COUNTERS) & set(counts)


def test_key_separates_what_the_step_branches_on():
    """Equal calls key equal; a None leaf (``obstacles.segs``), a shape, a
    dtype, the beep draw's flag, grad mode and the float32 matmul
    precision each give another key."""
    orca = BatchedNavEnv(EnvConfig.from_dict(cc.SMALL_RVO), "cpu", seed=1)
    states, _ = orca.reset(S)
    assert states.obstacles.segs is not None
    act = _actions(orca.cfg, S)
    u = torch.zeros(act.shape[:2])
    key = lambda st, a=act, flag=True: sg.key_of((st, a, u), flag)[0]
    base = key(states)
    assert key(map_tree(torch.clone, states)) == base
    no_segs = states._replace(
        obstacles=states.obstacles._replace(segs=None))
    assert key(no_segs) != base
    assert key(map_tree(lambda x: x[:2], states), act[:2]) != base
    assert key(states, act.double()) != base
    assert key(states, flag=False) != base
    with torch.no_grad():
        assert key(states) != base
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        assert key(states) != base
    finally:
        torch.set_float32_matmul_precision(saved)
    assert key(states) == base


def _replay_on_cpu(fn, args):
    """What a capture plans and a replay hands back, without a graph: the
    step run on the static inputs, its outputs planned into the arena."""
    key, leaves = sg.key_of(args)
    g = sg._Graph(leaves)
    outs = []
    g.out_spec = sg.flatten(fn(*sg.unflatten(key[0], g.static)), outs)
    sg._plan_outputs(g, outs)
    return g, leaves


@pytest.mark.parametrize("name", list(CONFIGS))
def test_outputs_equal_the_eager_step(name):
    """The outputs a replay hands back equal the eager step's bit for bit;
    the leaves the step passes through are the caller's own tensors, as
    the eager step's are; one tensor in two places stays one; and what a
    step returned is unchanged after the arena is written again."""
    env = BatchedNavEnv(EnvConfig.from_dict(CONFIGS[name]), "cpu", seed=3)
    states, _ = env.reset(S)
    act = _actions(env.cfg, S)
    u = torch.rand(act.shape[:2], generator=torch.Generator().manual_seed(0))
    args = (states, act, u)
    want = env.core._step_scenes(*args)
    g, leaves = _replay_on_cpu(env.core._step_scenes, args)
    got = g.outputs(leaves)
    _assert_trees_equal(got, want)
    assert got[0].robots.goal is states.robots.goal
    assert got[0].obs_map is states.obs_map
    assert got[0].robots.collision is got[1].is_collisions
    assert got[0].robots.beep is got[4]["beeps"]
    flat = []
    sg.flatten(got, flat)
    kept = [x.clone() for x in flat]
    g.arena.fill_(0x5A)
    g.outputs(leaves)
    assert all(torch.equal(a, b) for a, b in zip(flat, kept))


def test_copy_in_copies_only_what_changed():
    """A leaf is copied into its static buffer when it is another tensor
    (a fresh view of the same storage is the same), or when it was
    written in place since; otherwise not."""
    a, b = torch.arange(6.0).reshape(2, 3), torch.ones(4, dtype=torch.int32)
    g = sg._Graph([a[None], b])
    assert torch.equal(g.static[0], a[None]) and torch.equal(g.static[1], b)
    for x in g.static:
        x.zero_()
    g.copy_in([a[None], b])
    assert not g.static[0].any() and not g.static[1].any()
    a.add_(1.0)
    g.copy_in([a[None], b])
    assert torch.equal(g.static[0], a[None]) and not g.static[1].any()
    g.copy_in([a[None], b.clone()])
    assert torch.equal(g.static[1], b)
