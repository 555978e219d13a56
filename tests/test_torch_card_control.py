"""The control paths on the card, at the bench configurations of
``card_common.py``: reset, then control steps (MPPI K=128 H=12 acts,
then the env steps) of bench200, bench200ped (SFM), bench200ervo (ERVO,
the even robots beeping) and its 'orca' prediction head, fast bench200 and
fast bench200ped, and bench200 with two sensor groups.  Every control step
launches K1-K4 exactly as often as its sensor pass needs (K1 once, K2 and
K3 once per sensor group, K4 once with peds) and K5 never, and one warm
step runs with host syncs made errors (``torch.cuda.set_sync_debug_mode``:
the act and the step stay capturable in a CUDA graph).  Then the
block-painter path (K5 in place of K3, the same maps and lasers), the
scene batches of 4 x 50 and 16 x 12 robots under the scene-batched act
(every step without host syncs, K1 once for all scenes), and iLQR at
bench200.

These need an NVIDIA GPU and nvcc and skip without them.  On the machine
with the card (which has no JAX) run them without the JAX test conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py tests/test_torch_card_*.py

This file imports nothing of JAX.
"""

from typing import NamedTuple

import pytest
import torch

import card_common as cc
from img_env_tpu_torch import (BatchedNavEnv, EnvConfig, MpcController,
                               MppiConfig, NavEnv)
from img_env_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def no_tf32(dev):
    """float32 without TF32, as the CPU computes it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.fixture(scope="module")
def envs(dev):
    """``envs(cfg_dict)``: the NavEnv of a config, built at its first
    use."""
    built = {}

    def get(cfg_dict):
        name = cfg_dict["env_name"]
        if name not in built:
            built[name] = NavEnv(EnvConfig.from_dict(cfg_dict), dev)
        return built[name]
    return get


class Path(NamedTuple):
    cfg: dict
    warmup: int           # steps before the checked ones; the last of them
    steps: int            # runs with host syncs made errors
    launches: dict        # per control step; kernels not named: never
    beep: bool = False    # the even robots beep (the action's third column)
    head: str = "cv"      # the MPC's ped prediction


PATHS = {
    "bench200": Path(cc.BENCH200, 3, 10, cc.SENSORS),
    "bench200ped": Path(cc.BENCH200PED, 3, 20, cc.CROWD),
    "bench200ervo": Path(cc.BENCH200ERVO, 3, 12, cc.CROWD, beep=True),
    "bench200ervo_orca_head": Path(cc.BENCH200ERVO, 1, 2, cc.CROWD, beep=True,
                                   head="orca"),
    "fast200": Path(cc.FAST200, 3, 10, cc.SENSORS),
    "fast200ped": Path(cc.FAST200PED, 3, 10, cc.CROWD),
    "groups200": Path(cc.GROUPS200, 1, 2, {"raster": 1, "fill": 2,
                                           "paint": 2}),
}


def _expect_shapes(obs, shapes):
    for f, shape in shapes.items():
        x = getattr(obs, f)
        assert tuple(x.shape) == shape, (f, tuple(x.shape))
        assert bool(torch.isfinite(x).all()), f


@pytest.mark.parametrize("name", list(PATHS))
def test_control_path(dev, envs, name):
    """Reset and ``warmup + steps`` control steps: each launches the
    path's kernels exactly as ``Path.launches`` says, the last warm-up
    step without host syncs; the observations have the bench shapes and
    are finite, the MPC costs finite; with peds the peds move, with beeps
    some robot beeps."""
    p = PATHS[name]
    env = envs(p.cfg)
    ctl = MpcController(env, MppiConfig(horizon=cc.H, samples=cc.K),
                        ped_prediction=p.head)
    want = {k: p.launches.get(k, 0) for k in kernels.LAUNCHES}
    state0, _ = env.reset()
    state, mss = state0, ctl.init_state()
    total = torch.zeros((), dtype=torch.float64, device=dev)
    beeps = torch.zeros((), dtype=torch.float64, device=dev)
    for i in range(p.warmup + p.steps):
        before = dict(kernels.LAUNCHES)
        torch.cuda.set_sync_debug_mode("error" if i == p.warmup - 1 else 0)
        try:
            actions, mss, costs = ctl.act(state, mss)
            if p.beep:
                actions[0::2, 2] = 1.0
            state, obs, _, _, info = env.step(state, actions)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert cc.launch_delta(before) == want, i
        total += obs.sensor_maps.sum() + obs.lasers.sum() + costs.sum()
        beeps += info["beeps"].sum()
    assert bool(torch.isfinite(total))
    n = env.cfg.robot.total
    shapes = {"sensor_maps": (n, 48, 48), "lasers": (n, 960)}
    if "pedmap" in p.launches:
        shapes.update(ped_vector_states=(n, 71), ped_maps=(n, 3, 48, 48),
                      ped_min_dists=(n,))
        moved = (state.peds.pos - state0.peds.pos).norm(dim=-1).mean()
        assert float(moved) > 0.0
    elif name == "bench200":
        shapes.update(vector_states=(n, 3), angular_maps=(n, 72))
    _expect_shapes(obs, shapes)
    if p.beep:
        assert float(beeps) > 0


def test_block_path(dev, envs):
    """bench200 with paint_mode='block': reset and 3 steps, each through
    K5 and never K3; then, from that state, the block env's sensor maps,
    lasers and collision codes equal the default env's (K3) bit for
    bit."""
    env_default = envs(cc.BENCH200)
    env = NavEnv(EnvConfig.from_dict(dict(cc.BENCH200, paint_mode="block")),
                 dev)
    state, _ = env.reset()
    act = torch.zeros((env.cfg.robot.total, 3), device=dev)
    act[:, 0], act[:, 1] = 0.4, 0.3
    want = {k: 0 for k in kernels.LAUNCHES}
    want.update(raster=1, fill=1, paint_block=1)
    for _ in range(3):
        before = dict(kernels.LAUNCHES)
        state, *_ = env.step(state, act)
        assert cc.launch_delta(before) == want
    _, o_b = env._observe(state)
    _, o_d = env_default._observe(state)
    for f in ("sensor_maps", "lasers", "is_collisions"):
        assert torch.equal(getattr(o_b, f), getattr(o_d, f)), f


@pytest.mark.parametrize("cfg_dict", [cc.MULTI_4X50, cc.MULTI_16X12],
                         ids=["4x50", "16x12"])
def test_batch_control_path(dev, cfg_dict):
    """A scene batch's control loop: reset, then 13 control steps (the
    scene-batched act, then the batch step), every one with host syncs
    made errors and launching K1, K2 and K3 exactly once for all scenes,
    K4 and K5 never; bench shapes, finite."""
    benv = BatchedNavEnv(EnvConfig.from_dict(cfg_dict), dev)
    ctl = MpcController(benv.core, MppiConfig(horizon=cc.H, samples=cc.K))
    states, _ = benv.reset()
    s, n = states.robots.pose.shape[:2]
    mss = ctl.init_scenes_state(s)
    want = {k: cc.SENSORS.get(k, 0) for k in kernels.LAUNCHES}
    total = torch.zeros((), dtype=torch.float64, device=dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(13):
            before = dict(kernels.LAUNCHES)
            actions, mss, costs = ctl.act_scenes(states, mss)
            states, obs, *_ = benv.step(states, actions)
            assert cc.launch_delta(before) == want, i
            total += obs.sensor_maps.sum() + obs.lasers.sum() + costs.sum()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(total))
    _expect_shapes(obs, {"sensor_maps": (s, n, 48, 48),
                         "lasers": (s, n, 960), "vector_states": (s, n, 3)})


def test_ilqr_bench200(dev, envs):
    """``MpcController(method='ilqr')`` at bench200 (horizon 12, 8
    iterations, 5 step sizes): reset and 7 control steps, each launching
    K1-K3 once and K4 and K5 never; the costs finite and the robots' mean
    goal distance falling."""
    env = envs(cc.BENCH200)
    ctl = MpcController(env, MppiConfig(horizon=cc.H, samples=cc.K),
                        method="ilqr")
    state, _ = env.reset()
    mss = ctl.init_state()
    goal_d = lambda st: float((st.robots.goal - st.robots.pose[:, :2])
                              .norm(dim=-1).mean())
    d0 = goal_d(state)
    want = {k: cc.SENSORS.get(k, 0) for k in kernels.LAUNCHES}
    for i in range(7):
        before = dict(kernels.LAUNCHES)
        actions, mss, costs = ctl.act(state, mss)
        state, *_ = env.step(state, actions)
        assert cc.launch_delta(before) == want, i
    assert bool(torch.isfinite(costs).all())
    assert goal_d(state) < d0
