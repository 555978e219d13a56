"""The torch port's ORCA / ERVO crowd vs the JAX package and the sequential
NumPy oracle (img_env_tpu/oracle/orca_oracle.py).

Tolerances.  In float64 one step agrees with the JAX solver within 1e-9
and with the oracle within 1e-8 (the JAX tests' own bound,
tests/test_orca.py:70); measured ~1e-15.  A 15-step rollout agrees with
the JAX rollout within 1e-9 and with the oracle within 1e-6
(tests/test_orca.py:96).  In float32 the velocities agree with the jitted
JAX solver within 2e-3 m/s, and for 95% of the peds within 2e-5 (measured
over 20 dense scenes of 30 peds: at most 7.6e-4, and 1e-6 typically).
The cause is the LP: two nearly parallel constraint lines turn one-ulp
differences (XLA contracts multiply-adds, torch does not) into a shift of
their intersection along the lines; the float32 solution of either
package moves by up to 1e-2 against its float64 solution on the same
scenes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img_env_tpu.crowd import orca as jorca
from img_env_tpu.crowd.obstacle_split import split_segments as jsplit
from img_env_tpu.mpc import prediction as jpred
from img_env_tpu.oracle import orca_oracle
from img_env_tpu_torch.crowd import orca
from img_env_tpu_torch.crowd.obstacle_split import split_segments
from img_env_tpu_torch.mpc import prediction

from tests.test_orca import _cluster_scene, _np_pref

T = torch.as_tensor
ONES = lambda n: torch.ones(n, dtype=torch.bool)


def _evac(robot_pos):
    """One beeping robot, one silent slot (radius 0, the reference's
    sentinel) and a wide beep."""
    return (np.stack([robot_pos[0], np.zeros(2), robot_pos[1]]),
            np.array([1.0, 0.0, 1.5]))


def _step_both(scene, cfg_kw, evac, dtype=np.float64):
    pp, pv, goals, pr, pms, rp, rv, aabbs = (np.asarray(x, dtype)
                                             for x in scene)
    m, n = len(pp), len(rp)
    pref = np.asarray(_np_pref(pp, goals), dtype)
    src, rad = (np.asarray(x, dtype) for x in _evac(rp)) if evac else (None,
                                                                        None)

    def jstep(pp, pv, pref, pr, pms, rp, rv, aabbs, src, rad):
        seg, _ = jsplit(aabbs, jnp.ones(len(aabbs), bool))
        return jorca.orca_step(pp, pv, pref, pr, pms, jnp.ones(m, bool), rp,
                               rv, jnp.ones(n, bool),
                               jorca.OrcaConfig(**cfg_kw), seg,
                               evac_sources=src, evac_radii=rad)

    with jax.enable_x64(dtype == np.float64):
        want = jax.jit(jstep)(pp, pv, pref, pr, pms, rp, rv, aabbs, src, rad)
    seg, _ = split_segments(T(aabbs), ONES(len(aabbs)))
    got = orca.orca_step(
        T(pp), T(pv), T(pref), T(pr), T(pms), ONES(m), T(rp), T(rv), ONES(n),
        orca.OrcaConfig(**cfg_kw), seg,
        evac_sources=None if src is None else T(src),
        evac_radii=None if rad is None else T(rad))
    return got, want, (pp, pv, pref, pr, pms, rp, rv, aabbs, src, rad)


@pytest.mark.parametrize("evac", [False, True], ids=["orca", "ervo"])
@pytest.mark.parametrize("trial", range(4))
def test_orca_step_f64_matches_jax_and_oracle(trial, evac):
    scene = _cluster_scene(np.random.default_rng(trial))
    (gp, gv), (jp, jv), args = _step_both(
        scene, dict(time_step=0.4, max_obs_segments=16), evac)
    pp, pv, pref, pr, pms, rp, rv, aabbs, src, rad = args
    op, ov = orca_oracle.orca_oracle_step(
        pp, pv, pref, pr, pms, rp, rv, aabbs, time_step=0.4,
        evac_sources=src, evac_radii=rad)
    assert gv.dtype == torch.float64
    np.testing.assert_allclose(gv.numpy(), np.asarray(jv), atol=1e-9, rtol=0)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jp), atol=1e-9, rtol=0)
    np.testing.assert_allclose(gv.numpy(), ov, atol=1e-8, rtol=0)
    np.testing.assert_allclose(gp.numpy(), op, atol=1e-8, rtol=0)


@pytest.mark.parametrize("trial", range(5))
def test_orca_step_f32_matches_jax(trial):
    """Dense scenes (30 peds, 6 robots, 4 rectangles, one beep), float32,
    against the jitted JAX solver; tolerance in the module docstring."""
    scene = _cluster_scene(np.random.default_rng(trial), m=30, n_rob=6,
                           n_obs=4)
    (gp, gv), (jp, jv), _ = _step_both(
        scene, dict(time_step=0.4), True, np.float32)
    assert gv.dtype == torch.float32
    d = np.abs(gv.numpy() - np.asarray(jv)).max(1)
    assert d.max() <= 2e-3, d.max()
    assert (d <= 2e-5).mean() >= 0.95, np.sort(d)[-5:]
    dp = np.abs(gp.numpy() - np.asarray(jp)).max(1)
    assert dp.max() <= 2e-3 * 0.4 + 1e-6


def test_orca_rollout_f64():
    """15 steps (tests/test_orca.py:74): the port against the JAX rollout
    and the oracle, each fed its own previous state."""
    (pp, pv, goals, pr, pms, rp, rv,
     aabbs) = _cluster_scene(np.random.default_rng(0), m=6, n_rob=2, n_obs=2)
    m, n = len(pp), len(rp)
    seg_j, _ = jsplit(jnp.asarray(aabbs), jnp.ones(len(aabbs), bool))
    seg_t, _ = split_segments(T(aabbs), ONES(len(aabbs)))
    cfg_j, cfg_t = jorca.OrcaConfig(time_step=0.4), orca.OrcaConfig(
        time_step=0.4)
    step_j = jax.jit(lambda p, v, pref: jorca.orca_step(
        p, v, pref, jnp.asarray(pr), jnp.asarray(pms), jnp.ones(m, bool),
        jnp.asarray(rp), jnp.asarray(rv), jnp.ones(n, bool), cfg_j, seg_j))
    jp, jv = jnp.asarray(pp), jnp.asarray(pv)
    tp, tv = T(pp), T(pv)
    op, ov = pp.copy(), pv.copy()
    for step in range(15):
        jp, jv = step_j(jp, jv, jorca.pref_velocity(jp, jnp.asarray(goals)))
        tp, tv = orca.orca_step(
            tp, tv, orca.pref_velocity(tp, T(goals)), T(pr), T(pms), ONES(m),
            T(rp), T(rv), ONES(n), cfg_t, seg_t)
        op, ov = orca_oracle.orca_oracle_step(
            op, ov, _np_pref(op, goals), pr, pms, rp, rv, aabbs,
            time_step=0.4)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-9,
                                   rtol=0, err_msg=f"step {step}")
        np.testing.assert_allclose(tp.numpy(), op, atol=1e-6, rtol=0,
                                   err_msg=f"step {step}")


def _random_lines(rng, m, k_obs, k_agents):
    """Lines through a disc of radius 1.5 with random directions; a few
    invalid slots, and some lines pushed outward so that the programs are
    infeasible within the speed disc."""
    n = k_obs + k_agents
    pts = rng.uniform(-1.5, 1.5, (m, n, 2))
    ang = rng.uniform(-np.pi, np.pi, (m, n))
    dirs = np.stack([np.cos(ang), np.sin(ang)], -1)
    far = rng.random((m, n)) < 0.3
    pts = np.where(far[..., None], pts * 3.0, pts)
    # a parallel pair in some programs (linearProgram1's parallel branch)
    dirs[::3, 1] = dirs[::3, 0]
    dirs[1::3, n - 1] = -dirs[1::3, n - 2]
    valid = rng.random((m, n)) > 0.15
    speed = rng.uniform(0.3, 0.8, m)
    pref = rng.uniform(-1.0, 1.0, (m, 2))
    return pts, dirs, valid, speed, pref


def test_batched_lp_matches_sequential():
    """solve_velocities (batched lp1 tables, one selection chain for the
    main and the L inner programs, the lp3 chain) against the oracle's
    plain sequential linearProgram2/3 over the valid lines, in float64.
    Most programs here fail linearProgram2 and reach linearProgram3."""
    rng = np.random.default_rng(3)
    k_obs, k_agents = 6, 5
    pts, dirs, valid, speed, pref = _random_lines(rng, 60, k_obs, k_agents)
    got = orca.solve_velocities(T(pts), T(dirs), T(valid), T(speed),
                                T(pref), k_obs).numpy()
    reached_lp3 = 0
    for i in range(len(pts)):
        lines = [(pts[i, j], dirs[i, j]) for j in range(k_obs + k_agents)
                 if valid[i, j]]
        n_obs = int(valid[i, :k_obs].sum())
        res, fail = orca_oracle.lp2(lines, speed[i], pref[i], False)
        if fail < len(lines):
            reached_lp3 += 1
            res = orca_oracle.lp3(lines, n_obs, fail, speed[i], res)
        np.testing.assert_allclose(got[i], res, atol=1e-12, rtol=0,
                                   err_msg=f"program {i}")
    assert reached_lp3 >= 20, reached_lp3


def test_segments_from_aabbs_match_jax():
    aabbs = np.array([[1.0, 2.0, 1.5, 3.0], [4.0, 4.0, 4.2, 5.5],
                      [2.0, 2.0, 2.0, 2.5]])
    valid = np.array([True, False, True])
    want = jorca.segments_from_aabbs(jnp.asarray(aabbs), jnp.asarray(valid))
    got = orca.segments_from_aabbs(T(aabbs), T(valid))
    for f in orca.Segments._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def test_pref_velocity_rule():
    pos = T(np.zeros((3, 2)))
    goal = T(np.array([[3.0, 4.0], [0.3, 0.4], [0.0, 0.0]]))
    got = orca.pref_velocity(pos, goal).numpy()
    want = np.asarray(jorca.pref_velocity(jnp.asarray(pos.numpy()),
                                          jnp.asarray(goal.numpy())))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got[0], [0.6, 0.8], atol=1e-12)


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("obstacles", [False, True], ids=["open", "split"])
def test_predict_orca_matches_jax(x64, obstacles):
    """The 'orca' head: H = 6 ORCA steps toward extrapolated goals, with
    the episode's split segments or none."""
    rng = np.random.default_rng(11)
    dt = np.float64 if x64 else np.float32
    m, h = 10, 6
    center = rng.uniform(3, 7, 2)
    pos = (center + rng.uniform(-0.8, 0.8, (m, 2))).astype(dt)
    vel = rng.uniform(-0.5, 0.5, (m, 2)).astype(dt)
    vmax = rng.uniform(0.4, 0.6, m).astype(dt)
    aabbs = np.array([[center[0] - 1.0, center[1] + 0.9, center[0] + 1.0,
                       center[1] + 1.2]], dt)
    cfg_j, cfg_t = jorca.OrcaConfig(), orca.OrcaConfig()
    with jax.enable_x64(x64):
        seg_j = (jsplit(jnp.asarray(aabbs), jnp.ones(1, bool))[0]
                 if obstacles else None)
        want = jax.jit(lambda p, v, s: jpred.predict_peds(
            "orca", p, v, s, h, 0.4, orca_cfg=cfg_j, segments=seg_j))(
                pos, vel, vmax)
    seg_t = split_segments(T(aabbs), ONES(1))[0] if obstacles else None
    got = prediction.predict_peds("orca", T(pos), T(vel), T(vmax), h, 0.4,
                                  orca_cfg=cfg_t, segments=seg_t)
    assert got.shape == (h, m, 2)
    tol = 1e-9 if x64 else 2e-3 * 0.4 * h
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=0)
    assert (np.abs(np.diff(got.numpy(), axis=0)) > 0).any()
