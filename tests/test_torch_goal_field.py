"""The port's geodesic goal field and the cost lookups beside it
(``img_env_tpu_torch.mpc.cost``) against the JAX package's, and the
goal-field MPPI solve with injected noise.

``geodesic_field`` is bit-exact: every step is a float add and a min, so
the port's pooled form (one add of each step length after a 3x3-box and a
plus-shaped minimum) rounds to the reference's bits; held on
``tests/test_goal_field.py``'s maps in float32 (the jitted JAX program) and
float64, and on a generated BARN world's EDT at the view resolution with
several goals, and against a Dijkstra.  The lookups match to a few float32
ulps (XLA contracts the bilinear weights into multiply-adds).  The MPPI
solve with the field follows F12's tolerances: float32 actions within
5e-4 and costs within rtol 1e-4, float64 within 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img_env_tpu.config import SpeedLimiterConfig as JaxLimiterConfig
from img_env_tpu.datasets import barn as jbarn
from img_env_tpu.dynamics.limiter import LimiterParams as JLim
from img_env_tpu.mpc import cost as jcost
from img_env_tpu.mpc import mppi as jmppi
from img_env_tpu_torch.config import EnvConfig, SpeedLimiterConfig
from img_env_tpu_torch.dynamics.limiter import LimiterParams
from img_env_tpu_torch.env.maps import load_static_map
from img_env_tpu_torch.mpc import cost, mppi
from img_env_tpu_torch.mpc.edt import edt2d
from tests.test_goal_field import RES, _dijkstra, _u_map


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


def _barn_edt(tmp_path_factory, seed=5):
    """A generated BARN world's EDT as the env sees the map: 0.05 m cells
    (95 x 95), meters."""
    occ = jbarn.generate_barn_world(seed)
    path = str(tmp_path_factory.mktemp("barn") / "w.png")
    jbarn.save_world_png(path, occ)
    cfg = EnvConfig.from_dict(jbarn.world_cfg_dict(path))
    return edt2d(load_static_map(cfg) < 250, 0.05).astype(np.float32)


FIELD_CASES = {
    "u_map_f32": (lambda: np.where(_u_map(), 0.0, 10.0).astype(np.float32),
                  RES, [[1.0, 0.2], [0.3, 1.7]], 0.01, False),
    "u_map_f64": (lambda: np.where(_u_map(), 0.0, 10.0), RES,
                  [[1.0, 0.2], [1.45, 1.05]], 0.01, True),
    "empty_16": (lambda: np.full((16, 16), 10.0, np.float32), RES,
                 [[0.8, 0.8]], 0.01, False),
}


def _jax_fields(edt, res, goals, radius, x64, iters=0):
    with jax.enable_x64(x64):
        return np.asarray(jax.jit(jax.vmap(lambda g: jcost.geodesic_field(
            jnp.asarray(edt), res, g, radius, iters)))(jnp.asarray(goals)))


@pytest.mark.parametrize("name", list(FIELD_CASES))
def test_geodesic_field_bit_exact(name):
    make, res, goals, radius, x64 = FIELD_CASES[name]
    edt = make()
    goals = np.asarray(goals, edt.dtype)
    want = _jax_fields(edt, res, goals, radius, x64)
    got = cost.geodesic_field(torch.as_tensor(edt), res,
                              torch.as_tensor(goals), radius).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_geodesic_field_bit_exact_on_a_barn_world(tmp_path_factory):
    """Per-robot fields over per-robot EDTs ([N, H, W], as ``batched_mppi``
    builds them), at BARN's 95 x 95 view grid and the start, goal and
    mid-world cells; and a cut iteration count."""
    edt = _barn_edt(tmp_path_factory)
    goals = np.array([[4.2, 2.4], [0.6, 2.4], [2.4, 1.3]], np.float32)
    want = _jax_fields(edt, 0.05, goals, 0.17, False)
    got = cost.geodesic_field(torch.as_tensor(edt)[None].expand(3, -1, -1),
                              0.05, torch.as_tensor(goals), 0.17).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert want[0, 12, 48] < want.max()     # the start reaches the goal
    want = _jax_fields(edt, 0.05, goals[:1], 0.17, False, iters=40)
    got = cost.geodesic_field(torch.as_tensor(edt), 0.05,
                              torch.as_tensor(goals[0]), 0.17, iters=40)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want[0]))


def test_field_matches_dijkstra_and_routes_around_pocket():
    occ = _u_map()
    edt = torch.as_tensor(np.where(occ, 0.0, 10.0))
    f = cost.geodesic_field(edt, RES, torch.tensor([10 * RES, 2 * RES]),
                            0.01).numpy()
    np.testing.assert_allclose(f, _dijkstra(~occ, (10, 2), RES), atol=1e-4)
    assert f[10, 10] > f[2, 10]
    assert f[10, 10] > np.hypot(0.0, 8 * RES) + 0.5


def _pair_wc(edt, res, aabb, field=None):
    """The same world as a JAX WorldCost and the port's (one scene)."""
    wc_j = jcost.WorldCost(edt=jnp.asarray(edt), resolution=res,
                           obs_aabb=jnp.asarray(aabb),
                           obs_valid=jnp.asarray([True, False, True][
                               :aabb.shape[0]]),
                           robot_radius=0.17,
                           goal_field=None if field is None
                           else jnp.asarray(field))
    wc_t = cost.WorldCost(edt=torch.as_tensor(edt)[None], resolution=res,
                          obs_aabb=torch.as_tensor(aabb)[None],
                          obs_valid=torch.as_tensor(np.array(wc_j.obs_valid))[None],
                          robot_radius=0.17,
                          scene=torch.zeros(1, dtype=torch.int64),
                          goal_field=None if field is None
                          else torch.as_tensor(field)[None])
    return wc_j, wc_t


def test_lookups_match_jax(tmp_path_factory):
    """``static_distance`` (nearest cell, 0 off the map), the bilinear
    ``static_distance_smooth``, both with AABBs (one invalid), the field
    lookup of ``goal_distance`` and its straight-line fallback, and
    ``ped_clearance``, float32 jitted on 400 points over and off the map."""
    edt = _barn_edt(tmp_path_factory)
    goal = np.array([4.2, 2.4], np.float32)
    field = _jax_fields(edt, 0.05, goal[None], 0.17, False)[0]
    aabb = np.array([[1.0, 1.0, 1.4, 1.6], [2.0, 2.0, 2.5, 2.5],
                     [3.3, 0.8, 2.9, 1.2]], np.float32)
    rng = np.random.default_rng(1)
    xy = rng.uniform(-0.3, 5.0, (400, 2)).astype(np.float32)
    peds = rng.uniform(0, 4.5, (3, 2)).astype(np.float32)
    pvel = rng.uniform(-0.5, 0.5, (3, 2)).astype(np.float32)
    ped_r = np.array([0.2, 0.3, 0.25], np.float32)
    t_idx = rng.integers(0, 8, 400).astype(np.int32)
    with jax.enable_x64(False):
        wc_j, wc_t = _pair_wc(edt, 0.05, aabb, field)
        want = jax.jit(lambda xy, t: (
            jcost.static_distance(wc_j, xy),
            jcost.static_distance_smooth(wc_j, xy),
            jcost.goal_distance(wc_j, xy, jnp.asarray(goal)),
            jcost.goal_distance(wc_j._replace(goal_field=None), xy,
                                jnp.asarray(goal)),
            jcost.ped_clearance(xy, t, jnp.asarray(peds), jnp.asarray(pvel),
                                jnp.asarray(ped_r), 0.4)))(xy, t_idx)
    pts = torch.as_tensor(xy)[None]
    g = torch.as_tensor(goal)[None]
    got = (cost.static_distance(wc_t, pts)[0],
           cost.static_distance_smooth(wc_t, pts)[0],
           cost.goal_distance(wc_t, pts, g)[0],
           cost.goal_distance(wc_t._replace(goal_field=None), pts, g)[0],
           cost.ped_clearance(torch.as_tensor(xy), torch.as_tensor(t_idx),
                              torch.as_tensor(peds), torch.as_tensor(pvel),
                              torch.as_tensor(ped_r), 0.4))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for k in range(1, 5):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-6, atol=2e-6, err_msg=str(k))


K, H = 64, 8


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "f64"])
def test_goal_field_batched_mppi_matches_jax(x64, tmp_path_factory):
    """run_barn's profile (H = 8, K = 64, the corridor weights, the field
    over each robot's goal) for 3 robots in one BARN world, each avoiding
    the others' tracks, with JAX's per-robot noise injected."""
    dt = np.float64 if x64 else np.float32
    edt = _barn_edt(tmp_path_factory).astype(dt)
    n = 3
    poses = np.array([[0.6, 2.4, 1.57], [0.7, 1.5, 1.2], [4.0, 3.0, -1.5]],
                     dt)
    goals = np.array([[4.2, 2.4], [4.2, 1.8], [0.6, 2.4]], dt)
    rng = np.random.default_rng(3)
    vw0 = rng.uniform(0, 0.3, (n, 2)).astype(dt)
    vw1 = rng.uniform(0, 0.3, (n, 2)).astype(dt)
    nominal = rng.uniform(0.0, 0.4, (n, H, 2)).astype(dt)
    robot_traj = (poses[None, :, :2]
                  + rng.uniform(-0.1, 0.1, (H, n, 2))).astype(dt)
    robot_r = np.full(n, 0.17, dt)
    w8 = dict(goal=6.0, terminal_goal=30.0, clearance=15.0, safety_dist=0.25)
    key = jax.random.PRNGKey(9)
    with jax.enable_x64(x64):
        keys = jax.random.split(key, n)
        noise = np.array(jax.vmap(lambda k: jax.random.normal(
            k, (K, H, 2)))(keys))
        wc = jcost.WorldCost(edt=jnp.asarray(edt), resolution=0.05,
                             obs_aabb=jnp.zeros((0, 4), dt),
                             obs_valid=jnp.zeros((0,), bool),
                             robot_radius=0.17)
        lim = JLim.from_config(JaxLimiterConfig())
        want = jax.jit(lambda: jmppi.batched_mppi(
            keys, jnp.asarray(nominal), jnp.asarray(poses),
            jnp.asarray(vw0), jnp.asarray(vw1), jnp.asarray(goals), wc,
            lim, lim, jnp.zeros((H, 0, 2), dt), jnp.zeros((0,), dt),
            jmppi.MppiConfig(horizon=H, samples=K, goal_field=True),
            jcost.CostWeights(**w8), 0.4, False,
            robot_traj=jnp.asarray(robot_traj),
            robot_r=jnp.asarray(robot_r)))()
    t = torch.as_tensor
    wc_t = cost.WorldCost(edt=t(edt)[None], resolution=0.05,
                          obs_aabb=torch.zeros((1, 0, 4), dtype=t(edt).dtype),
                          obs_valid=torch.zeros((1, 0), dtype=torch.bool),
                          robot_radius=0.17,
                          scene=torch.zeros(n, dtype=torch.int64))
    lim_t = LimiterParams.from_config(SpeedLimiterConfig())
    got = mppi.batched_mppi(
        t(noise), t(nominal), t(poses), t(vw0), t(vw1), t(goals), wc_t,
        lim_t, lim_t, torch.zeros((1, H, 0, 2), dtype=t(edt).dtype),
        torch.zeros((0,), dtype=t(edt).dtype),
        mppi.MppiConfig(horizon=H, samples=K, goal_field=True),
        cost.CostWeights(**w8), 0.4, False, robot_traj=t(robot_traj),
        robot_r=t(robot_r))
    act, nom, c = (5e-4, 1e-3, 1e-4) if not x64 else (1e-9, 1e-9, 1e-9)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=act, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=nom, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=c)
