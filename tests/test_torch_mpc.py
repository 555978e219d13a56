"""MPPI act of the torch port vs the JAX MpcController.

Both packages get the same Gaussian draws: the test makes the JAX
controller's own noise (``jax.random.split`` per robot, then
``jax.random.normal``) and hands it to the port's ``act_fn``.

Tolerances: in float64 the two agree to 1e-9 (measured ~1e-12), which holds
the algorithm — limiter, arcs, EDT windows, neighbour sets, weights — to
the JAX package.  In float32 (production) costs agree within rtol 1e-4
(measured <= 6e-6); actions and the shifted plan agree within atol 5e-4 and
1e-3 (measured up to 1.4e-4 and 4.6e-4): XLA fuses and contracts the cost
arithmetic differently from torch, and the softmax over costs of ~200
turns 1e-6 relative cost differences into ~1e-4 shifts of the weighted
mean action.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.config import SpeedLimiterConfig as JaxLimiterConfig
from img_env_tpu.dynamics.limiter import LimiterParams as JLim
from img_env_tpu.env.nav_env import NavEnv as JaxNavEnv
from img_env_tpu.mpc import cost as jcost
from img_env_tpu.mpc import mppi as jmppi
from img_env_tpu.mpc.controller import MpcController as JaxMpc
from img_env_tpu_torch.config import EnvConfig, SpeedLimiterConfig
from img_env_tpu_torch.core.convert import world_state_from_numpy
from img_env_tpu_torch.dynamics.limiter import LimiterParams
from img_env_tpu_torch.env.nav_env import NavEnv
from img_env_tpu_torch.mpc import cost, mppi
from img_env_tpu_torch.mpc.controller import MpcController, MpcState

from tests.test_torch_env import orca_cfg_dict, ped_cfg_dict, small_cfg_dict

K, H = 128, 12


def _jax_noise(key, n):
    keys = jax.random.split(key, n)
    return jax.vmap(lambda k: jax.random.normal(k, (K, H, 2)))(keys)


TOLS = {False: dict(act=5e-4, nom=1e-3, cost=1e-4),
        True: dict(act=1e-9, nom=1e-9, cost=1e-9)}


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("n_rob", [4, 20])
def test_act_matches_jax(n_rob, x64):
    """4 robots: every other robot joins the avoidance set; 20 robots: the
    16 nearest (top-k pruning).  The dtype follows the JAX state's."""
    d = small_cfg_dict(n_rob=n_rob)
    tol = TOLS[x64]
    with jax.enable_x64(x64):
        env_j = JaxNavEnv(JaxEnvConfig.from_dict(d))
        ctl_j = JaxMpc(env_j, jmppi.MppiConfig(horizon=H, samples=K))
        state_j, _ = env_j.reset(jax.random.PRNGKey(3))
        ms_j = ctl_j.init_state()
    env_t = NavEnv(EnvConfig.from_dict(d), "cpu")
    ctl_t = MpcController(env_t, mppi.MppiConfig(horizon=H, samples=K))
    for step in range(2):
        key = jax.random.PRNGKey(10 + step)
        ms_t = MpcState(torch.as_tensor(np.array(ms_j.nominal)))
        with jax.enable_x64(x64):
            noise = np.array(_jax_noise(key, n_rob))
            a_j, ms_j, c_j = jax.jit(ctl_j.act_fn)(key, state_j, ms_j)
        state_t = world_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, state_j))
        a_t, ms_t, c_t = ctl_t.act_fn(state_t, ms_t, torch.as_tensor(noise))
        assert a_t.dtype == state_t.robots.pose.dtype
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j),
                                   atol=tol["act"], rtol=0)
        np.testing.assert_allclose(ms_t.nominal.numpy(),
                                   np.asarray(ms_j.nominal), atol=tol["nom"],
                                   rtol=0)
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j),
                                   rtol=tol["cost"])
        # both continue from the JAX step (the state moves, velocities > 0)
        with jax.enable_x64(x64):
            state_j, *_ = env_j.step(state_j, np.asarray(a_j))


def test_batched_mppi_pooled_edt():
    """The min-pooled EDT window (pool 4 at the production 0.015 m cells)
    and an AABB term, called directly on a synthetic clearance field."""
    rng = np.random.default_rng(5)
    res, n = 0.015, 6
    edt = (rng.random((420, 380)) * 2.0).astype(np.float32)
    poses = np.stack([rng.uniform(1.5, 4.5, n), rng.uniform(1.5, 4.0, n),
                      rng.uniform(-3, 3, n)], -1).astype(np.float32)
    goals = (poses[:, :2] + rng.uniform(-2, 2, (n, 2))).astype(np.float32)
    vw0 = rng.uniform(-0.3, 0.3, (n, 2)).astype(np.float32)
    vw1 = rng.uniform(-0.3, 0.3, (n, 2)).astype(np.float32)
    nominal = rng.uniform(-0.2, 0.4, (n, H, 2)).astype(np.float32)
    aabb = np.array([[2.0, 2.0, 2.4, 2.5]], np.float32)
    robot_traj = (poses[None, :, :2]
                  + rng.uniform(-0.1, 0.1, (H, n, 2))).astype(np.float32)
    robot_r = np.full(n, 0.17, np.float32)
    cfg_j = jmppi.MppiConfig(horizon=H, samples=K, avoid_k=3)
    cfg_t = mppi.MppiConfig(horizon=H, samples=K, avoid_k=3)
    with jax.enable_x64(False):
        key = jax.random.PRNGKey(7)
        noise = np.array(_jax_noise(key, n))
        wc = jcost.WorldCost(edt=jnp.asarray(edt), resolution=res,
                             obs_aabb=jnp.asarray(aabb),
                             obs_valid=jnp.ones((1,), bool),
                             robot_radius=0.17)
        lim = JLim.from_config(JaxLimiterConfig())
        want = jax.jit(lambda: jmppi.batched_mppi(
            jax.random.split(key, n), jnp.asarray(nominal),
            jnp.asarray(poses), jnp.asarray(vw0), jnp.asarray(vw1),
            jnp.asarray(goals), wc, lim, lim, jnp.zeros((H, 0, 2)),
            jnp.zeros((0,)), cfg_j, jcost.CostWeights(), 0.4, False,
            robot_traj=jnp.asarray(robot_traj),
            robot_r=jnp.asarray(robot_r)))()
    wc_t = cost.WorldCost(edt=torch.as_tensor(edt)[None], resolution=res,
                          obs_aabb=torch.as_tensor(aabb)[None],
                          obs_valid=torch.ones((1, 1), dtype=torch.bool),
                          robot_radius=0.17,
                          scene=torch.zeros(n, dtype=torch.int64))
    lim_t = LimiterParams.from_config(SpeedLimiterConfig())
    t = torch.as_tensor
    got = mppi.batched_mppi(
        t(noise), t(nominal), t(poses), t(vw0), t(vw1), t(goals), wc_t,
        lim_t, lim_t, torch.zeros((1, H, 0, 2)), torch.zeros((0,)), cfg_t,
        cost.CostWeights(), 0.4, False, robot_traj=t(robot_traj),
        robot_r=t(robot_r))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-4)


def test_act_without_episode_edt_uses_static_edt():
    """A state without the episode EDT falls back to the host EDT of the
    static map plus the obstacle AABBs (controller.world_cost), float64."""
    d = small_cfg_dict()
    with jax.enable_x64(True):
        env_j = JaxNavEnv(JaxEnvConfig.from_dict(d))
        ctl_j = JaxMpc(env_j, jmppi.MppiConfig(horizon=H, samples=K))
        state_j, _ = env_j.reset(jax.random.PRNGKey(4))
        state_j = state_j._replace(obs_edt=jnp.zeros((1, 1)))
        key = jax.random.PRNGKey(20)
        noise = np.array(_jax_noise(key, N := d["robot"]["total"]))
        a_j, ms_j, c_j = jax.jit(ctl_j.act_fn)(key, state_j,
                                               ctl_j.init_state())
    env_t = NavEnv(EnvConfig.from_dict(d), "cpu")
    ctl_t = MpcController(env_t, mppi.MppiConfig(horizon=H, samples=K))
    state_t = world_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, state_j))
    np.testing.assert_allclose(ctl_t.static_edt.numpy(),
                               np.asarray(ctl_j.static_edt))
    a_t, ms_t, c_t = ctl_t.act_fn(
        state_t, MpcState(torch.zeros((N, H, 2), dtype=torch.float64)),
        torch.as_tensor(noise))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-9)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-9)


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("head", ["cv", "sfm", "orca"])
def test_act_with_peds_matches_jax(head, x64):
    """The pedscene config after two crowd steps (peds moving): the
    avoidance set is every ped, predicted by the head, plus the other
    robots.  Same noise, same tolerances as without peds."""
    d = ped_cfg_dict(n_rob=3, n_ped=2)
    tol = TOLS[x64]
    with jax.enable_x64(x64):
        env_j = JaxNavEnv(JaxEnvConfig.from_dict(d))
        ctl_j = JaxMpc(env_j, jmppi.MppiConfig(horizon=H, samples=K),
                       ped_prediction=head)
        state_j, _ = env_j.reset(jax.random.PRNGKey(11))
        for _ in range(2):
            state_j, *_ = env_j.step(state_j, np.tile(
                np.asarray([[0.3, 0.2, 0.0]]), (3, 1)))
        key = jax.random.PRNGKey(12)
        noise = np.array(_jax_noise(key, 3))
        a_j, ms_j, c_j = jax.jit(ctl_j.act_fn)(key, state_j,
                                               ctl_j.init_state())
    assert float(jnp.abs(state_j.peds.vel).max()) > 0
    env_t = NavEnv(EnvConfig.from_dict(d), "cpu")
    ctl_t = MpcController(env_t, mppi.MppiConfig(horizon=H, samples=K),
                          ped_prediction=head)
    state_t = world_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, state_j))
    dtype = state_t.robots.pose.dtype
    a_t, ms_t, c_t = ctl_t.act_fn(
        state_t, MpcState(torch.zeros((3, H, 2), dtype=dtype)),
        torch.as_tensor(noise))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j),
                               atol=tol["act"], rtol=0)
    np.testing.assert_allclose(ms_t.nominal.numpy(), np.asarray(ms_j.nominal),
                               atol=tol["nom"], rtol=0)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j),
                               rtol=tol["cost"])


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_act_with_orca_head_and_segments_matches_jax(x64):
    """The 'orca' head in an rvoscene episode: the prediction runs against
    the reset's split segments (controller.py:104-109), after two crowd
    steps.  Same noise and tolerances as the other heads."""
    d = orca_cfg_dict("rvoscene")
    tol = TOLS[x64]
    with jax.enable_x64(x64):
        env_j = JaxNavEnv(JaxEnvConfig.from_dict(d))
        ctl_j = JaxMpc(env_j, jmppi.MppiConfig(horizon=H, samples=K),
                       ped_prediction="orca")
        state_j, _ = env_j.reset(jax.random.PRNGKey(13))
        for _ in range(2):
            state_j, *_ = env_j.step(state_j, np.tile(
                np.asarray([[0.3, 0.2, 0.0]]), (3, 1)))
        key = jax.random.PRNGKey(14)
        noise = np.array(_jax_noise(key, 3))
        a_j, ms_j, c_j = jax.jit(ctl_j.act_fn)(key, state_j,
                                               ctl_j.init_state())
    assert state_j.obstacles.segs is not None
    env_t = NavEnv(EnvConfig.from_dict(d), "cpu")
    ctl_t = MpcController(env_t, mppi.MppiConfig(horizon=H, samples=K),
                          ped_prediction="orca")
    state_t = world_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, state_j))
    assert state_t.obstacles.segs is not None
    dtype = state_t.robots.pose.dtype
    a_t, ms_t, c_t = ctl_t.act_fn(
        state_t, MpcState(torch.zeros((3, H, 2), dtype=dtype)),
        torch.as_tensor(noise))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j),
                               atol=tol["act"], rtol=0)
    np.testing.assert_allclose(ms_t.nominal.numpy(), np.asarray(ms_j.nominal),
                               atol=tol["nom"], rtol=0)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j),
                               rtol=tol["cost"])


def test_unported_prediction_head_raises():
    """A head other than 'orca' or 'sfm' ('sgan') plans with 'cv', as the
    reference does (F24): its act equals the port's 'cv' act bit for bit
    and the JAX package's 'sgan' act within the float32 tolerances; every
    ``method`` builds (the reference plans 'cem' with MPPI: ROADMAP F23)."""
    d = ped_cfg_dict(n_rob=3, n_ped=2)
    tol = TOLS[False]
    with jax.enable_x64(False):
        env_j = JaxNavEnv(JaxEnvConfig.from_dict(d))
        ctl_j = JaxMpc(env_j, jmppi.MppiConfig(horizon=H, samples=K),
                       ped_prediction="sgan")
        state_j, _ = env_j.reset(jax.random.PRNGKey(11))
        for _ in range(2):
            state_j, *_ = env_j.step(state_j, np.tile(
                np.asarray([[0.3, 0.2, 0.0]]), (3, 1)))
        key = jax.random.PRNGKey(12)
        noise = np.array(_jax_noise(key, 3))
        a_j, _, _ = jax.jit(ctl_j.act_fn)(key, state_j, ctl_j.init_state())
    env_t = NavEnv(EnvConfig.from_dict(d), "cpu")
    state_t = world_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, state_j))
    acts = {}
    for head in ("sgan", "cv"):
        ctl_t = MpcController(env_t, mppi.MppiConfig(horizon=H, samples=K),
                              ped_prediction=head)
        acts[head] = ctl_t.act_fn(
            state_t, MpcState(torch.zeros((3, H, 2), dtype=torch.float32)),
            torch.as_tensor(noise))[0]
    assert torch.equal(acts["sgan"], acts["cv"])
    np.testing.assert_allclose(acts["sgan"].numpy(), np.asarray(a_j),
                               atol=tol["act"], rtol=0)
    for method in ("mppi", "cem", "ilqr"):
        assert MpcController(env_t, method=method).method == method


def _one_robot(dt):
    """One robot in a random clearance field with two AABBs (one invalid)
    and two predicted peds: the single-robot planners' inputs."""
    rng = np.random.default_rng(12)
    edt = (rng.random((80, 70)) * 1.5).astype(dt)
    aabb = np.array([[3.0, 3.2, 3.4, 3.9], [1.0, 1.0, 1.5, 1.5]], dt)
    pose = np.array([2.5, 2.6, 0.7], dt)
    goal = np.array([5.5, 4.5], dt)
    vw = rng.uniform(0, 0.3, (2, 2)).astype(dt)
    nominal = rng.uniform(0.0, 0.4, (H, 2)).astype(dt)
    ts = np.arange(1, H + 1)[:, None, None] * 0.4
    peds = (np.array([[3.5, 2.5], [2.0, 3.5]])[None]
            + np.array([[0.1, 0.2], [0.3, -0.1]])[None] * ts).astype(dt)
    return edt, aabb, pose, goal, vw, nominal, peds, np.array([0.3, 0.2], dt)


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("planner", ["mppi_plan", "cem_plan"])
def test_single_robot_planners_match_jax(planner, x64):
    """The one-robot ``mppi_plan`` (full-map lookups) and ``cem_plan``
    (3 refits of 32 elites, the lower index first on cost ties, the
    deviation with ddof 0) on the JAX draws: ``jax.random.normal`` of the
    key, and of its ``cem_iters`` splits for CEM.  Same tolerances as the
    batched act."""
    dt = np.float64 if x64 else np.float32
    edt, aabb, pose, goal, vw, nominal, peds, ped_r = _one_robot(dt)
    key = jax.random.PRNGKey(21)
    cfg_j = jmppi.MppiConfig(horizon=H, samples=K)
    with jax.enable_x64(x64):
        if planner == "cem_plan":
            noise = np.array(jax.vmap(lambda k: jax.random.normal(
                k, (K, H, 2)))(jax.random.split(key, cfg_j.cem_iters)))
        else:
            noise = np.array(jax.random.normal(key, (K, H, 2)))
        wc = jcost.WorldCost(edt=jnp.asarray(edt), resolution=0.1,
                             obs_aabb=jnp.asarray(aabb),
                             obs_valid=jnp.asarray([True, False]),
                             robot_radius=0.17)
        lim = JLim.from_config(JaxLimiterConfig())
        want = jax.jit(lambda: getattr(jmppi, planner)(
            key, jmppi.PlannerState(jnp.asarray(nominal)), jnp.asarray(pose),
            jnp.asarray(vw[0]), jnp.asarray(vw[1]), jnp.asarray(goal), wc,
            lim, lim, jnp.asarray(peds), jnp.asarray(ped_r), cfg_j,
            jcost.CostWeights(), 0.4, False))()
    t = torch.as_tensor
    wc_t = cost.WorldCost(edt=t(edt)[None], resolution=0.1,
                          obs_aabb=t(aabb)[None],
                          obs_valid=torch.tensor([[True, False]]),
                          robot_radius=0.17,
                          scene=torch.zeros(1, dtype=torch.int64))
    lim_t = LimiterParams.from_config(SpeedLimiterConfig())
    got = getattr(mppi, planner)(
        t(noise), mppi.PlannerState(t(nominal)), t(pose), t(vw[0]), t(vw[1]),
        t(goal), wc_t, lim_t, lim_t, t(peds), t(ped_r),
        mppi.MppiConfig(horizon=H, samples=K), cost.CostWeights(), 0.4,
        False)
    tol = TOLS[x64]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=tol["act"], rtol=0)
    np.testing.assert_allclose(got[1].nominal.numpy(),
                               np.asarray(want[1].nominal), atol=tol["nom"],
                               rtol=0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=tol["cost"])


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_cem_elites_take_the_lower_index_on_ties(sign):
    """Equal costs: the elite is the lower-index candidate, as
    ``jax.lax.top_k`` orders them.  A robot held at v = 0 turning at +w or
    -w pays one cost, so candidates (+-0.1, +-0.2, ...) tie in pairs; the
    first of the cheapest pair is the plan."""
    cfg = mppi.MppiConfig(horizon=4, samples=8, elites=1, cem_iters=1,
                          v_range=(0.0, 0.0))
    noise = torch.zeros((1, 8, 4, 2))
    w = torch.tensor([1.0, -1.0, 2.0, -2.0, 3.0, -3.0, 4.0, -4.0]) / 3
    noise[0, :, :, 1] = sign * w[:, None]
    wc = cost.WorldCost(edt=torch.full((1, 20, 20), 5.0), resolution=0.1,
                        obs_aabb=torch.zeros((1, 0, 4)),
                        obs_valid=torch.zeros((1, 0), dtype=torch.bool),
                        robot_radius=0.17,
                        scene=torch.zeros(1, dtype=torch.int64))
    lim = LimiterParams.from_config(SpeedLimiterConfig())
    act, ps, c = mppi.cem_plan(
        noise, mppi.init_planner(cfg, "cpu"), torch.tensor([1.0, 1.0, 0.0]),
        torch.zeros(2), torch.zeros(2), torch.tensor([1.5, 1.0]), wc, lim,
        lim, torch.zeros((4, 0, 2)), torch.zeros(0), cfg)
    assert float(act[1]) == pytest.approx(sign * 0.1, abs=1e-7)
    assert float(act[0]) == 0.0
