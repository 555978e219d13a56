"""The env step replayed from CUDA graphs on the card
(``img_env_tpu_torch/env/step_graph.py``) against the eager path of the
same env (``NavEnv._step_scenes`` in place of ``step_scenes``), from the
same state and generator state, 8 steps or more each:

* bench200 through ``NavEnv.step`` (one scene, 200 robots);
* a stage-5 batch of 4 scenes, one scene redrawn by ``reset_local`` and
  ``index_copy``'d in after the fourth step;
* an ERVO batch of 4 scenes with ``beep_u`` handed in (the even scenes
  beeping);
* the PPO trainer's rollout over the world-of-one mesh (NCCL), which
  draws ``beep_u`` before the core step.

Every leaf of state, observation, reward, done and info is bit-equal to
the eager path's, over the tensors of every step kept to the end (so what
step t returned is unchanged after step t+5 and later); the kernel
launches (``kernels.LAUNCHES``) and the trace counts of each step equal
the eager path's; one capture (``env.graph_captures``) and every step a
replay (``env.graph_replays / (env.graph_replays + env.eager_steps)``
1.0); and every step after the capture makes no host sync
(``torch.cuda.set_sync_debug_mode("error")``).

These need an NVIDIA GPU and nvcc and skip without them.  On the machine
with the card (which has no JAX) run them without the JAX test conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py tests/test_torch_card_*.py

This file imports nothing of JAX.
"""

import contextlib

import pytest
import torch
import torch.distributed as dist

import card_common as cc
from img_env_tpu_torch import BatchedNavEnv, EnvConfig, NavEnv
from img_env_tpu_torch.core.state import map_tree
from img_env_tpu_torch.ops import kernels
from img_env_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

STEPS = 8
S = 4
ERVO_ENV = "img_env_tpu_torch/artifacts/ervo_policy_env.json"
GRAPH = ("env.graph_captures", "env.graph_replays", "env.eager_steps",
         "env.graph_failures")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def no_tf32(dev):
    """float32 without TF32, as the harness runs the env."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.fixture(scope="module", autouse=True)
def world_of_one(dev):
    """The rollout's mesh starts a world of one; end it after the
    module."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.drain()
    yield
    torch.cuda.set_sync_debug_mode(0)
    trace.disable()
    trace.drain()


@contextlib.contextmanager
def eager(core: NavEnv):
    """The same env stepping eagerly: ``step_scenes`` is the eager
    routine for the block."""
    core.step_scenes = core._step_scenes
    try:
        yield
    finally:
        del core.step_scenes


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    return [x for part in tree for x in _leaves(part)]


def _assert_same(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a, b), i


def _run(step, steps: int, between=None):
    """``steps`` calls of ``step(t)``, tracing on, every call after the
    first with host syncs made errors; ``between(t)`` runs before call t,
    outside.  Returns every call's output (kept, not copied), its kernel
    launches and trace counts, and the graph counters summed."""
    outs, launches, counts, graph = [], [], [], dict.fromkeys(GRAPH, 0)
    for t in range(steps):
        if between is not None:
            between(t)
        before = dict(kernels.LAUNCHES)
        trace.drain()
        trace.enable()
        torch.cuda.set_sync_debug_mode("error" if t else 0)
        try:
            outs.append(step(t))
        finally:
            torch.cuda.set_sync_debug_mode(0)
            trace.disable()
        launches.append(cc.launch_delta(before))
        _, c = trace.drain()
        for k in GRAPH:
            graph[k] += c.pop(k, 0)
        counts.append(c)
    return outs, launches, counts, graph


def _graph_vs_eager(core: NavEnv, step, steps: int, between=None):
    """``_run`` on the graph path, then again eagerly from the same
    generator state: the same outputs, launches and counts a step; one
    capture, every step a replay."""
    gen = core.generator.get_state()
    outs, launches, counts, graph = _run(step, steps, between)
    core.generator.set_state(gen)
    with eager(core):
        outs_e, launches_e, counts_e, graph_e = _run(step, steps, between)
    _assert_same(outs, outs_e)
    assert launches == launches_e
    assert counts == counts_e
    assert graph == {"env.graph_captures": 1, "env.graph_replays": steps,
                     "env.eager_steps": 0, "env.graph_failures": 0}, graph
    assert graph_e == dict.fromkeys(GRAPH, 0)
    return outs, launches


def _actions(cfg: EnvConfig, shape, seed: int, steps: int, dev):
    """Uniform commands within the config's ranges, one set a step."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo = torch.tensor([r[0] for r in cfg.continuous_actions[:2]], device=dev)
    hi = torch.tensor([r[1] for r in cfg.continuous_actions[:2]], device=dev)
    out = []
    for _ in range(steps):
        a = lo + (hi - lo) * torch.rand(shape + (2,), generator=gen,
                                        device=dev)
        out.append(torch.cat([a, torch.zeros(shape + (1,), device=dev)], -1))
    return out


def test_bench200_step(dev):
    """bench200 through ``NavEnv.step``: 10 steps under random commands,
    graph against eager; K1-K3 once a step on both."""
    env = NavEnv(EnvConfig.from_dict(cc.BENCH200), dev, seed=1)
    state0, _ = env.reset()
    acts = _actions(env.cfg, (env.cfg.robot.total,), 2, 10, dev)
    hold = {"state": state0}

    def step(t):
        out = env.step(hold["state"], acts[t])
        hold["state"] = out[0]
        return out

    def between(t):
        if t == 0:
            hold["state"] = state0

    outs, launches = _graph_vs_eager(env, step, 10, between)
    want = {k: cc.SENSORS.get(k, 0) for k in kernels.LAUNCHES}
    assert launches == [want] * 10
    assert outs[-1][1].sensor_maps.shape == (env.cfg.robot.total, 48, 48)


def test_stage5_batch_with_redraw(dev):
    """A stage-5 batch of 4 scenes: 9 steps, scene 1 redrawn through
    ``reset_local`` and ``index_copy``'d in before the fifth step (a new
    map, clearance field, goals and peds, same shapes: no second
    capture)."""
    benv = BatchedNavEnv(EnvConfig.from_yaml(cc.POLICY_ENV), dev, seed=7)
    states0, _ = benv.reset(S)
    redrawn, _ = benv.reset_local([benv.core.sample_scenario()])
    idx = torch.tensor([1], device=dev)
    acts = _actions(benv.cfg, (S, benv.cfg.robot.total), 3, 9, dev)
    hold = {}

    def between(t):
        if t == 0:
            hold["states"] = states0
        if t == 4:
            hold["states"] = map_tree(
                lambda old, new: old.index_copy(0, idx, new),
                hold["states"], redrawn)

    def step(t):
        out = benv.step(hold["states"], acts[t])
        hold["states"] = out[0]
        return out

    _graph_vs_eager(benv.core, step, 9, between)


def test_ervo_batch_with_beep_u(dev):
    """An ERVO batch of 4 scenes, 8 steps, ``beep_u`` handed in and the
    even scenes' robots beeping: graph against eager, some robot beeps."""
    benv = BatchedNavEnv(EnvConfig.from_yaml(ERVO_ENV), dev, seed=3)
    states0, _ = benv.reset(S)
    n = benv.cfg.robot.total
    acts = _actions(benv.cfg, (S, n), 4, STEPS, dev)
    for a in acts:
        a[0::2, :, 2] = 0.5
    gen = torch.Generator(device=dev).manual_seed(5)
    beep_u = [torch.rand((S, n), generator=gen, device=dev)
              for _ in range(STEPS)]
    hold = {}

    def between(t):
        if t == 0:
            hold["states"] = states0

    def step(t):
        out = benv.step(hold["states"], acts[t], beep_u=beep_u[t])
        hold["states"] = out[0]
        return out

    outs, _ = _graph_vs_eager(benv.core, step, STEPS, between)
    assert int(sum(o[4]["beeps"].sum() for o in outs)) > 0


def test_trainer_rollout_on_mesh_of_one(dev):
    """The PPO rollout (8 steps of 4 stage-5 scenes) over the world-of-one
    mesh: the graph path's trajectory, final state and observation equal
    the eager path's; one capture, 8 replays; a second rollout from the
    same start replays without host syncs and gives the same bits."""
    from img_env_tpu_torch.models.policy import PolicyConfig, init_policy
    from img_env_tpu_torch.parallel.mesh import make_mesh
    from img_env_tpu_torch.train import ppo

    cfg = EnvConfig.from_yaml(cc.POLICY_ENV)
    env = BatchedNavEnv(cfg, dev, seed=11, mesh=make_mesh())
    gen = torch.Generator(device=dev).manual_seed(5)
    model, params = init_policy(gen, PolicyConfig.from_env_config(cfg), dev)
    _, train_step = ppo.make_train_step(env, model,
                                        ppo.PpoConfig(unroll=STEPS))
    states, obs = env.reset(S)
    g0 = env.core.generator.get_state()

    def rollout():
        gen.manual_seed(9)
        env.core.generator.set_state(g0)
        return train_step.rollout(params, states, obs, gen, None)

    before = dict(kernels.LAUNCHES)
    trace.enable()
    got = rollout()
    trace.disable()
    launches = cc.launch_delta(before)
    _, counts = trace.drain()
    graph = {k: counts.pop(k, 0) for k in GRAPH}
    assert graph == {"env.graph_captures": 1, "env.graph_replays": STEPS,
                     "env.eager_steps": 0, "env.graph_failures": 0}, graph
    before = dict(kernels.LAUNCHES)
    trace.enable()
    with eager(env.core):
        want = rollout()
    trace.disable()
    assert cc.launch_delta(before) == launches
    _, counts_e = trace.drain()
    assert counts_e == counts
    _assert_same(got, want)
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = rollout()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _assert_same(again, want)
