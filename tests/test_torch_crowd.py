"""The crowd of the torch port vs the JAX package: ped statics, trajectory
goals, the gait, the Social Force Model and the SFM prediction head.

Tolerances: the SFM in float64 agrees with the JAX package to 1e-9 over 20
steps (the pattern of tests/test_sfm.py; the two differ only in the last
bits of exp/atan2/sqrt).  In float32 one step agrees within 2e-6 m and
2e-6 m/s: XLA contracts multiply-adds and its transcendental functions
round differently from torch's, which moves the forces by a few ulps.
Trajectory goals and the gait are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.crowd import common as jcommon
from img_env_tpu.crowd import gait as jgait
from img_env_tpu.crowd import sfm as jsfm
from img_env_tpu.env import nav_env as jnav
from img_env_tpu.mpc import prediction as jpred
from img_env_tpu.oracle.sfm_oracle import sfm_oracle_step
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.crowd import common, gait, sfm
from img_env_tpu_torch.env import nav_env
from img_env_tpu_torch.mpc import prediction

from tests.test_sfm import _build_states, _scene
from tests.test_torch_statics import _assert_tree_equal
from tests.test_torch_env import ped_cfg_dict

T = torch.as_tensor
PED_FIELDS = ("ped_body_points", "ped_body_mask", "ped_left_points",
              "ped_left_mask", "ped_right_points", "ped_right_mask",
              "ped_rest_left", "ped_rest_right", "ped_is_leg", "ped_r",
              "ped_max_speed", "ped_wp_xy", "ped_wp_r", "ped_wp_count")


def _scripted(d):
    d["ped_sim"]["waypoints"] = [[[3.0, 4.0, 0.5], [6.0, 7.0]],
                                 [[2.0, 2.5], [8.0, 8.0, 1.0], [5.0, 5.0]]]
    return d


@pytest.mark.parametrize("variant", ["legs_and_circle", "scripted", "none"])
def test_ped_statics_match(variant):
    d = ped_cfg_dict()
    if variant == "scripted":
        d = _scripted(d)
    elif variant == "none":
        d["ped_sim"] = {"total": 0, "type": ""}
    sj = jnav.build_statics(JaxEnvConfig.from_dict(d))
    st = nav_env.build_statics(EnvConfig.from_dict(d))
    for f in PED_FIELDS:
        _assert_tree_equal(getattr(sj, f), getattr(st, f), f)


def test_advance_traj_goals_exact():
    """Random queues, plus peds on their waypoint, at the end of the queue
    (the index freezes at len) and with an empty queue."""
    rng = np.random.default_rng(0)
    m, w = 9, 3
    traj = rng.uniform(0, 10, (m, w, 2)).astype(np.float32)
    traj_len = np.array([1, 2, 3, 3, 2, 1, 0, 3, 2], np.int32)
    traj_idx = np.array([0, 1, 2, 3, 2, 0, 0, 1, 0], np.int32)
    pos = rng.uniform(0, 10, (m, 2)).astype(np.float32)
    for i in (0, 1, 2, 4, 8):      # within 0.2 m of the checked waypoint
        k = min(traj_idx[i], traj_len[i] - 1)
        pos[i] = traj[i, k] + 0.05
    with jax.enable_x64(False):
        want = jax.jit(jcommon.advance_traj_goals)(pos, traj, traj_len,
                                                   traj_idx)
    got = common.advance_traj_goals(T(pos), T(traj), T(traj_len),
                                    T(traj_idx))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert (got[1].numpy() != traj_idx).any()


def test_update_gait_exact():
    rng = np.random.default_rng(1)
    m = 64
    state = rng.integers(0, 7, m).astype(np.int32)
    resid = rng.uniform(0, 0.3, m).astype(np.float32)
    move = rng.uniform(0, 0.7, m).astype(np.float32)
    move[:8] = 0.0
    move[8:12] = np.float32(0.3) - resid[8:12]       # steps on the boundary
    rest_l = rng.uniform(-0.1, 0.1, (m, 2)).astype(np.float32)
    rest_r = rng.uniform(-0.1, 0.1, (m, 2)).astype(np.float32)
    with jax.enable_x64(False):
        want = jax.jit(jgait.update_gait)(state, resid, move, rest_l, rest_r)
    got = gait.update_gait(T(state), T(resid), T(move), T(rest_l),
                           T(rest_r))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def _torch_wp(wp):
    return sfm.SfmWaypointState(*(T(np.array(x)) for x in wp))


@pytest.mark.parametrize("trial", range(3))
def test_sfm_rollout_f64(trial):
    """20 steps of peds + robot mirrors + 2 obstacles, float64, 1e-9."""
    rng = np.random.default_rng(100 + trial)
    pos, vel, vmax, goals, starts, segs, m, n_rob = _scene(rng)
    wp_j, _ = _build_states(pos, vel, vmax, goals, starts, m, n_rob)
    wp_t = _torch_wp(wp_j)
    seg_a = np.stack([s[0] for s in segs])
    seg_b = np.stack([s[1] for s in segs])
    a = m + n_rob
    valid = np.ones(a, bool)
    valid[-1] = trial != 1              # a mirror outside the crowd
    jp, jv = jnp.asarray(pos), jnp.asarray(vel)
    tp, tv = T(pos), T(vel)
    step_j = jax.jit(jsfm.sfm_step)
    for step in range(20):
        jp, jv, wp_j = step_j(jp, jv, jnp.asarray(vmax), jnp.asarray(valid),
                              wp_j, jnp.asarray(seg_a), jnp.asarray(seg_b),
                              jnp.ones(2, bool), 0.4)
        tp, tv, wp_t = sfm.sfm_step(tp, tv, T(vmax), T(valid), wp_t,
                                    T(seg_a), T(seg_b),
                                    torch.ones(2, dtype=torch.bool), 0.4)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-9,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-9,
                                   err_msg=f"step {step}")
        for f in ("dest_idx", "head", "has_dest"):
            np.testing.assert_array_equal(getattr(wp_t, f).numpy(),
                                          np.asarray(getattr(wp_j, f)))


def test_sfm_move_clamp_sequential():
    """Two crossing segments: the second tests the position the first
    rewrote (ped_agent.cpp:519-553), float64, against the JAX loop."""
    pos = np.array([[0.0, 0.0], [5.0, 5.0]])
    step = np.array([[2.0, 0.1], [0.3, 0.2]])
    seg_a = np.array([[1.0, -1.0], [0.5, -1.0]])
    seg_b = np.array([[1.0, 1.0], [0.5, 1.0]])
    valid = np.ones(2, bool)
    want = jax.jit(jsfm._move_clamp)(pos, step, seg_a, seg_b, valid)
    got = sfm._move_clamp(T(pos), T(step), T(seg_a), T(seg_b), T(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    assert got[0, 0] < 0.5           # clamped before the nearer segment


def test_sfm_waypoint_cycle():
    """tests/test_sfm.py:71: a ped reaching its r=1 goal refetches it, then
    sticks on the r=0 copy; the port against the sequential oracle."""
    goals = np.array([[1.0, 0.0]])
    starts = np.array([[-3.0, 0.0]])
    pos = np.array([[0.5, 0.0], [50.0, 50.0]])
    vel = np.zeros((2, 2))
    vmax = np.array([0.6, 1.2])
    wp_j, agents = _build_states(pos, vel, vmax, goals, starts, 1, 1)
    wp = _torch_wp(wp_j)
    tp, tv = T(pos), T(vel)
    e = torch.zeros((0, 2), dtype=torch.float64)
    for _ in range(12):
        tp, tv, wp = sfm.sfm_step(tp, tv, T(vmax),
                                  torch.ones(2, dtype=torch.bool), wp, e, e,
                                  torch.zeros(0, dtype=torch.bool), 0.4)
        sfm_oracle_step(agents, [], 0.4)
        np.testing.assert_allclose(tp[0].numpy(), agents[0].p, atol=1e-9)
    assert int(wp.dest_idx[0]) == 1
    assert bool(wp.has_dest[0])


def test_sfm_step_f32():
    rng = np.random.default_rng(7)
    pos, vel, vmax, goals, starts, segs, m, n_rob = _scene(rng, m=40,
                                                           n_rob=10)
    wp_j, _ = _build_states(pos, vel, vmax, goals, starts, m, n_rob)
    f = lambda x: np.asarray(x, np.float32)
    seg_a = f(np.stack([s[0] for s in segs]))
    seg_b = f(np.stack([s[1] for s in segs]))
    a = m + n_rob
    with jax.enable_x64(False):
        wpj = jsfm.SfmWaypointState(
            *(jnp.asarray(np.asarray(x), jnp.float32 if np.asarray(
                x).dtype == np.float64 else None) for x in wp_j))
        jp, jv, jw = jax.jit(jsfm.sfm_step)(
            f(pos), f(vel), f(vmax), np.ones(a, bool), wpj, seg_a, seg_b,
            np.ones(2, bool), 0.4)
    wpt = sfm.SfmWaypointState(*(T(np.array(x)) for x in wpj))
    tp, tv, tw = sfm.sfm_step(T(f(pos)), T(f(vel)), T(f(vmax)),
                              torch.ones(a, dtype=torch.bool), wpt,
                              T(seg_a), T(seg_b),
                              torch.ones(2, dtype=torch.bool), 0.4)
    assert tp.dtype == torch.float32
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=2e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-6)
    np.testing.assert_array_equal(tw.dest_idx.numpy(), np.asarray(jw.dest_idx))


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_predict_sfm_and_cv(x64):
    rng = np.random.default_rng(9)
    m, h = 12, 6
    dt = np.float64 if x64 else np.float32
    pos = rng.uniform(2, 8, (m, 2)).astype(dt)
    vel = rng.uniform(-0.5, 0.5, (m, 2)).astype(dt)
    vmax = rng.uniform(0.4, 0.6, m).astype(dt)
    with jax.enable_x64(x64):
        want_s = jax.jit(lambda p, v, s: jpred.predict_sfm(p, v, s, h, 0.4))(
            pos, vel, vmax)
        want_c = jpred.predict_cv(jnp.asarray(pos), jnp.asarray(vel), h, 0.4)
    got_s = prediction.predict_peds("sfm", T(pos), T(vel), T(vmax), h, 0.4)
    got_c = prediction.predict_peds("cv", T(pos), T(vel), T(vmax), h, 0.4)
    tol = 1e-9 if x64 else 1e-5
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=tol)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=tol)
    # any other head, and 'orca' without an orca_cfg, plans with 'cv', as
    # the reference does (img_env_tpu/mpc/prediction.py:84-94)
    for head in ("lstm", "orca"):
        got = prediction.predict_peds(head, T(pos), T(vel), T(vmax), h, 0.4)
        assert torch.equal(got, got_c), head
