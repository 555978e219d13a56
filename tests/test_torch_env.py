"""The torch port's reset and step vs the JAX NavEnv on a small config.

Both packages run in float32 (the production dtype): the JAX side under
``jax.enable_x64(False)``, because the test session turns x64 on.  On the
CPU the JAX env takes its XLA paths (gather fill, scatter raster, dense
painter) and the port its plain-torch kernel twins.  The JAX threefry draws
cannot be reproduced in torch, so the JAX sampler's layout is injected into
``reset_from_sample`` and the states are teacher-forced step by step.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.env.nav_env import NavEnv as JaxNavEnv
from img_env_tpu.env.sampler import sample_scenario_retry
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.core.convert import (
    world_state_from_numpy,
    world_state_to_numpy,
)
from img_env_tpu_torch.crowd.obstacle_split import split_segments
from img_env_tpu_torch.env.nav_env import NavEnv
from img_env_tpu_torch.env.sampler import ScenarioSample

# The port's CPU tests run torch on one thread.  A test run's workers
# share the machine's cores, and torch's intra-op pool in each of them
# oversubscribes the cores: a parallel run of tests/ took ~5x longer.
# Every worker imports this module when it collects the tests.
torch.set_num_threads(1)

N_ROB = 4


def small_cfg_dict(n_rob=N_ROB, n_obs=3):
    """tests/test_env_smoke.py's small config without pedestrians."""
    return {
        "robot": {
            "total": n_rob, "shape": ["circle"], "size": [[0.0, 0.0, 0.17]],
            "begin_poses_type": ["range"],
            "begin_poses": [[2.0, 9.0, 2.0, 9.0]],
            "target_poses_type": ["range"],
            "target_poses": [[2.0, 9.0, 2.0, 9.0]],
        },
        "object": {
            "total": n_obs, "shape": ["circle", "rectangle"],
            "size_range": [[0.2, 0.3], [-0.15, 0.15, -0.15, 0.15]],
            "poses_type": ["range"], "poses": [[2.5, 8.5, 2.5, 8.5]],
        },
        "ped_sim": {"total": 0, "type": ""},
        "global_map": {"resolution": 0.1, "map_file": "room_10.png"},
        "view_map": {"resolution": 0.05, "width": 3, "height": 3},
        "image_size": [48, 48],
        "range_total": 96,
        "control_hz": 0.4,
        "max_ped": 4,
    }


def ped_cfg_dict(n_rob=2, n_ped=2, n_obs=2):
    """tests/test_env_smoke.py's small pedscene config: one leg ped, one
    circle ped."""
    d = small_cfg_dict(n_rob=n_rob, n_obs=n_obs)
    d["ped_sim"] = {
        "total": n_ped, "type": "pedscene", "max_speed": [0.5],
        "shape": ["leg", "circle"], "size": [[0, 0.1, 0.1], [0, 0, 0.17]],
        "begin_poses_type": ["range"], "begin_poses": [[2.0, 9.0, 2.0, 9.0]],
        "target_poses_type": ["range"],
        "target_poses": [[2.0, 9.0, 2.0, 9.0]], "go_back": "yes",
    }
    d["ped_image_size"] = [48, 48]
    return d


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def envs():
    with jax.enable_x64(False):
        env_j = JaxNavEnv(JaxEnvConfig.from_dict(small_cfg_dict()))
    env_t = NavEnv(EnvConfig.from_dict(small_cfg_dict()), "cpu")
    return env_j, env_t


def _assert_vector_states(got, want):
    """Goal coordinates and velocities bit-exact; the relative yaw (column
    2 where state_dim is 3 or 5) within one float32 ulp: XLA takes glibc's
    atan2f, which is not correctly rounded, and the port the correctly
    rounded atan2 of the same glibc sin/cos (ROADMAP F17)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    exact = [k for k in range(got.shape[1]) if k != 2 or got.shape[1] == 4]
    np.testing.assert_array_equal(got[:, exact], want[:, exact])
    if got.shape[1] != 4:
        np.testing.assert_array_max_ulp(got[:, 2], want[:, 2], maxulp=1)


def _assert_obs_exact(obs_t, obs_j):
    for f in ("sensor_maps", "lasers", "angular_maps", "is_collisions",
              "is_arrives"):
        got = getattr(obs_t, f).numpy()
        want = np.asarray(getattr(obs_j, f))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f)
    np.testing.assert_array_equal(obs_t.hit_points.numpy(),
                                  np.asarray(obs_j.hit_points))


@pytest.mark.parametrize("seed", [0, 1])
def test_reset_from_jax_sample(envs, seed):
    env_j, env_t = envs
    key = jax.random.PRNGKey(seed)
    with jax.enable_x64(False):
        state_j, obs_j = env_j.reset(key)
        k_sample, _ = jax.random.split(key)
        spec = env_j.statics.sampler
        sc = jax.jit(lambda k: sample_scenario_retry(k, spec))(k_sample)
    sample = ScenarioSample(*(torch.as_tensor(np.array(x)) for x in sc))
    state_t, obs_t = env_t.reset(sample)

    np.testing.assert_array_equal(state_t.obs_map.numpy(),
                                  np.asarray(state_j.obs_map))
    np.testing.assert_array_equal(state_t.robots.pose.numpy(),
                                  np.asarray(state_j.robots.pose))
    np.testing.assert_array_equal(state_t.robots.goal.numpy(),
                                  np.asarray(state_j.robots.goal))
    np.testing.assert_array_equal(state_t.obstacles.aabb.numpy(),
                                  np.asarray(state_j.obstacles.aabb))
    np.testing.assert_allclose(state_t.obs_edt.numpy(),
                               np.asarray(state_j.obs_edt), atol=1e-5)
    _assert_obs_exact(obs_t, obs_j)
    _assert_vector_states(obs_t.vector_states.numpy(), obs_j.vector_states)


def test_teacher_forced_steps(envs):
    """Each step starts from the JAX state converted in.  The port's own
    step gives the JAX poses and vector states bit for bit (the relative
    yaw within an ulp), and the sensor surfaces, codes, rewards and dones
    exactly."""
    env_j, env_t = envs
    rng = np.random.default_rng(0)
    with jax.enable_x64(False):
        state_j, _ = env_j.reset(jax.random.PRNGKey(2))
    for step in range(3):
        acts = np.stack([rng.uniform(0.1, 0.6, N_ROB),
                         rng.uniform(-0.9, 0.9, N_ROB),
                         np.zeros(N_ROB)], -1).astype(np.float32)
        state_in = world_state_from_numpy(_np(state_j))
        with jax.enable_x64(False):
            adv_j, _, _ = env_j.advance_fn(state_j, jax.numpy.asarray(acts))
            state_j, obs_j, rew_j, done_j, _ = env_j.step(state_j, acts)

        # the port's own step from the same state
        st_t, obs_t, rew_t, done_t, info = env_t.step_fn(
            state_in, torch.as_tensor(acts))
        for f in ("pose", "vw_last0", "vw_last1", "vel_world"):
            np.testing.assert_array_equal(
                getattr(st_t.robots, f).numpy(),
                np.asarray(getattr(state_j.robots, f)), err_msg=f)
        _assert_vector_states(obs_t.vector_states.numpy(),
                              obs_j.vector_states)
        np.testing.assert_array_equal(obs_t.step_ds.numpy(),
                                      np.asarray(obs_j.step_ds))
        np.testing.assert_array_equal(obs_t.is_arrives.numpy(),
                                      np.asarray(obs_j.is_arrives))
        np.testing.assert_array_equal(info["beeps"].numpy(), 0)
        assert int(st_t.step) == int(state_j.step)

        # sensor surfaces from the same poses (teacher forcing)
        _, obs_f = env_t._observe(world_state_from_numpy(_np(adv_j)))
        _assert_obs_exact(obs_f, obs_j)
        rew_f = obs_f.is_arrives.float() - obs_f.is_collisions.float()
        np.testing.assert_array_equal(rew_f.numpy(), np.asarray(rew_j))
        np.testing.assert_array_equal(
            torch.clamp(torch.clamp(obs_f.is_collisions, -1, 1)
                        + obs_f.is_arrives, 0, 1).numpy(),
            np.asarray(done_j))
        np.testing.assert_array_equal(rew_t.numpy(), np.asarray(rew_j))
        np.testing.assert_array_equal(done_t.numpy(), np.asarray(done_j))


def test_state_roundtrip(envs):
    _, env_t = envs
    state, _ = env_t.reset()
    back = world_state_from_numpy(world_state_to_numpy(state))
    for a, b in zip(jax.tree_util.tree_leaves(world_state_to_numpy(state)),
                    jax.tree_util.tree_leaves(world_state_to_numpy(back))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("override", [
    {"sensor_mode": "reference"},
    {"sensor_mode": "reference", "use_laser": False},
    {"sensor_mode": "reference", "num_scenes": 2},
    {"sensor_mode": "reference", "num_scenes": 2, "mesh": True},
])
def test_unported_options_raise(override):
    """What the port does not run raises: the per-robot gather sensor mode
    (in the single env, in a scene batch and in a batch sharded over a
    mesh).  Fast mode, use_laser=False, num_scenes, sensor groups and a
    device mesh over the scenes run (tests/test_torch_fast_mode.py,
    test_torch_multiscene.py, test_torch_hetero_sensors.py,
    test_torch_multidev.py)."""
    from img_env_tpu_torch.parallel import BatchedNavEnv

    d = small_cfg_dict()
    d.update(override)
    mesh = d.pop("mesh", None)
    cfg = EnvConfig.from_dict(d)
    with pytest.raises(NotImplementedError):
        if cfg.num_scenes > 1:
            BatchedNavEnv(cfg, "cpu", mesh=object() if mesh else None)
        else:
            NavEnv(cfg, "cpu")


@pytest.mark.parametrize("override", [
    {"sensor_mode": "fast"}, {"use_laser": False}, {"num_scenes": 2}])
def test_fast_no_laser_and_num_scenes_options_run(override):
    d = small_cfg_dict()
    d.update(override)
    env = NavEnv(EnvConfig.from_dict(d), "cpu")
    _, obs = env.reset()
    assert obs.sensor_maps.shape == (N_ROB, 48, 48)


def test_unknown_sensor_mode_raises():
    d = small_cfg_dict()
    d["sensor_mode"] = "parityy"
    with pytest.raises(ValueError, match="parityy"):
        NavEnv(EnvConfig.from_dict(d), "cpu")


def test_unknown_crowd_model_raises():
    """A misspelled crowd model is refused, not run as a frozen crowd."""
    d = small_cfg_dict()
    d.update(ped_sim={"total": 2, "type": "pedscen"})
    with pytest.raises(ValueError, match="pedscen"):
        NavEnv(EnvConfig.from_dict(d), "cpu")


# ---------------------------------------------------------------------
# the crowd: pedscene (SFM leg + circle peds) and the gen-1 painter
# ---------------------------------------------------------------------

PED_EXACT = ("ped_vector_states", "ped_maps", "ped_min_dists")


@functools.lru_cache(maxsize=None)
def _jax_programs(env_j):
    """The JAX env's sampler, advance and observation, each jitted once
    per env (a jit of a fresh bound method or lambda traces and compiles
    anew at every call)."""
    spec = env_j.statics.sampler
    return (jax.jit(lambda k: sample_scenario_retry(k, spec)),
            jax.jit(env_j.advance_fn), jax.jit(env_j._observe))


def _jax_sample(env_j, key):
    with jax.enable_x64(False):
        k_sample, _ = jax.random.split(key)
        sc = _jax_programs(env_j)[0](k_sample)
    return ScenarioSample(*(torch.as_tensor(np.array(x)) for x in sc))


def _jax_step(env_j, state_j, acts):
    """The JAX step as its two parts, each from one jitted program: the
    state after the crowd and robot dynamics, its observation, and the
    observed state (the step's next state)."""
    _, advance, observe = _jax_programs(env_j)
    with jax.enable_x64(False):
        adv_j, _, _ = advance(state_j, jax.numpy.asarray(acts))
        state_j, obs_j = observe(adv_j, env_j.sensor_tables)
    return adv_j, obs_j, state_j


def _jax_advance_observe(env_j, state_j, acts):
    """The JAX state after the crowd and robot dynamics, and its
    observation, each from one jitted program."""
    return _jax_step(env_j, state_j, acts)[:2]


def _assert_ped_obs_exact(obs_t, obs_j):
    _assert_obs_exact(obs_t, obs_j)
    for f in PED_EXACT:
        got = getattr(obs_t, f).numpy()
        want = np.asarray(getattr(obs_j, f))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.fixture(scope="module")
def ped_envs():
    with jax.enable_x64(False):
        env_j = JaxNavEnv(JaxEnvConfig.from_dict(ped_cfg_dict()))
    env_t = NavEnv(EnvConfig.from_dict(ped_cfg_dict()), "cpu")
    return env_j, env_t


@pytest.mark.parametrize("seed", [0, 1])
def test_ped_reset_from_jax_sample(ped_envs, seed):
    env_j, env_t = ped_envs
    key = jax.random.PRNGKey(seed)
    with jax.enable_x64(False):
        state_j, obs_j = env_j.reset(key)
    state_t, obs_t = env_t.reset(_jax_sample(env_j, key))
    want = _np(state_j.peds)
    for f in state_t.peds._fields:
        np.testing.assert_array_equal(getattr(state_t.peds, f).numpy(),
                                      getattr(want, f), err_msg=f)
    np.testing.assert_array_equal(state_t.robots.pose.numpy(),
                                  np.asarray(state_j.robots.pose))
    _assert_ped_obs_exact(obs_t, obs_j)
    assert float(obs_t.ped_vector_states[0, 0]) == 2.0


def test_ped_teacher_forced_steps(ped_envs):
    """Each step starts from the JAX state.  The crowd (SFM + gait) agrees
    within f32 rounding: positions and velocities to 1e-5, the gait phase
    and every integer bookkeeping field exactly.  The first step of an
    episode is the exception for velocities (5e-3, measured 1.3e-3): every
    agent starts at rest, so the social force's interaction direction is
    parallel to the agents' offset and the sign of the angle between them
    (sfm.py ``theta_sign``) is rounding noise; float32 and float64 runs of
    the same package differ by as much.  Given the same (JAX) state, every
    observation surface is exact, including the ped layers of the packed
    map and the ped maps and vectors."""
    env_j, env_t = ped_envs
    rng = np.random.default_rng(4)
    with jax.enable_x64(False):
        state_j, _ = env_j.reset(jax.random.PRNGKey(5))
    n = env_t.cfg.robot.total
    for step in range(4):
        acts = np.stack([rng.uniform(0.1, 0.6, n), rng.uniform(-0.9, 0.9, n),
                         np.zeros(n)], -1).astype(np.float32)
        state_in = world_state_from_numpy(_np(state_j))
        adv_j, obs_j = _jax_advance_observe(env_j, state_j, acts)
        with jax.enable_x64(False):
            state_j, _, rew_j, done_j, _ = env_j.step(state_j, acts)
        st_t, obs_t, rew_t, done_t, _ = env_t.step_fn(state_in,
                                                      torch.as_tensor(acts))
        pj, pt = _np(state_j.peds), st_t.peds
        vtol = 5e-3 if step == 0 else 1e-5
        for f in ("pos", "prev_pos", "leg_offset"):
            np.testing.assert_allclose(getattr(pt, f).numpy(), getattr(pj, f),
                                       atol=1e-5, err_msg=f)
        np.testing.assert_allclose(pt.vel.numpy(), pj.vel, atol=vtol)
        np.testing.assert_allclose(
            st_t.crowd_aux.robot_vel.numpy(),
            np.asarray(state_j.crowd_aux.robot_vel), atol=vtol)
        for f in ("traj_idx", "gait_state", "sfm_wp_idx", "sfm_has_dest",
                  "sfm_lastdest"):
            np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                          getattr(pj, f), err_msg=f)
        _, obs_f = env_t._observe(world_state_from_numpy(_np(adv_j)))
        _assert_ped_obs_exact(obs_f, obs_j)
        np.testing.assert_array_equal(rew_t.numpy(), np.asarray(rew_j))
        np.testing.assert_array_equal(done_t.numpy(), np.asarray(done_j))


def test_ped_collision_code(ped_envs):
    """A leg ped moved onto robot 0 and the circle ped next to robot 1:
    both packages report collision code 2 (the ped bits of the packed
    map) from the same state."""
    env_j, env_t = ped_envs
    with jax.enable_x64(False):
        state_j, _ = env_j.reset(jax.random.PRNGKey(6))
        rp = state_j.robots.pose
        peds = state_j.peds._replace(pos=jax.numpy.stack(
            [rp[0, :2] + 0.12, rp[1, :2] - 0.15]))
        state_j = state_j._replace(peds=peds)
        _, obs_j = jax.jit(env_j._observe)(state_j, env_j.sensor_tables)
    _, obs_t = env_t._observe(world_state_from_numpy(_np(state_j)))
    _assert_ped_obs_exact(obs_t, obs_j)
    assert obs_t.is_collisions.tolist() == [2, 2]


@pytest.mark.parametrize("peds", [False, True], ids=["bench", "crowd"])
def test_block_painter_env_matches_jax(peds):
    """paint_mode='block' (the gen-1 layout, kernel K5 on the card): reset
    and two steps exact against the JAX package's env in the same mode."""
    d = ped_cfg_dict() if peds else small_cfg_dict()
    d["paint_mode"] = "block"
    with jax.enable_x64(False):
        env_j = JaxNavEnv(JaxEnvConfig.from_dict(d))
    env_t = NavEnv(EnvConfig.from_dict(d), "cpu")
    assert env_t.tables.painter.blocks is not None
    key = jax.random.PRNGKey(8)
    with jax.enable_x64(False):
        state_j, obs_j = env_j.reset(key)
    _, obs_t = env_t.reset(_jax_sample(env_j, key))
    _assert_ped_obs_exact(obs_t, obs_j)
    n = env_t.cfg.robot.total
    acts = np.tile(np.asarray([[0.4, 0.3, 0.0]], np.float32), (n, 1))
    for _ in range(2):
        adv_j, obs_j = _jax_advance_observe(env_j, state_j, acts)
        with jax.enable_x64(False):
            state_j, *_ = env_j.step(state_j, acts)
        _, obs_f = env_t._observe(world_state_from_numpy(_np(adv_j)))
        _assert_ped_obs_exact(obs_f, obs_j)


# ---------------------------------------------------------------------
# the ORCA crowds: rvoscene and ervoscene (beeps), reset with carry=
# ---------------------------------------------------------------------


def orca_cfg_dict(scene):
    """Three robots among four leg peds and three obstacles (two
    rectangles) in a 4 m square, so that peds, robots and segments meet
    within ORCA's 0.5 m neighbour distance."""
    d = ped_cfg_dict(n_rob=3, n_ped=4, n_obs=3)
    box = [[3.0, 7.0, 3.0, 7.0]]
    d["robot"].update(begin_poses=box, target_poses=box)
    d["object"].update(shape=["rectangle", "circle", "rectangle"],
                       size_range=[[-0.3, 0.3, -0.2, 0.2], [0.2, 0.3],
                                   [-0.15, 0.15, -0.4, 0.4]],
                       poses=[[3.5, 6.5, 3.5, 6.5]])
    d["ped_sim"].update(type=scene, shape=["leg"], size=[[0, 0.1, 0.1]],
                        begin_poses=box, target_poses=box)
    d.update(beep_r=1.5, ped_ca_p=0.8, target_min_dist=1.0)
    return d


ORCA_TOL = dict(pos=1e-3, vel=2e-3)   # f32 LP conditioning, test_torch_orca


@pytest.fixture(scope="module", params=["rvoscene", "ervoscene"])
def orca_envs(request):
    d = orca_cfg_dict(request.param)
    with jax.enable_x64(False):
        env_j = JaxNavEnv(JaxEnvConfig.from_dict(d))
    return env_j, NavEnv(EnvConfig.from_dict(d), "cpu")


def _beep_draw(state_j, n):
    """The JAX step's beep uniforms (nav_env.py:646, common.py:54)."""
    with jax.enable_x64(False):
        key_beep, _ = jax.random.split(state_j.rng)
        return torch.as_tensor(np.array(jax.random.uniform(key_beep, (n,))))


@pytest.mark.parametrize("seed", [21, 22])
def test_orca_reset_builds_split_segments(orca_envs, seed):
    """The reset's split segments: convexity, validity and order equal the
    JAX reset's; points within one float32 ulp (the obstacle corners of a
    rotated rectangle can differ by one: XLA contracts the rotation's
    multiply-adds), and equal to the port's split of the JAX corners."""
    env_j, env_t = orca_envs
    key = jax.random.PRNGKey(seed)
    with jax.enable_x64(False):
        state_j, obs_j = env_j.reset(key)
    state_t, obs_t = env_t.reset(_jax_sample(env_j, key))
    segs_j, segs_t = _np(state_j.obstacles.segs), state_t.obstacles.segs
    assert segs_t is not None
    same_corners, _ = split_segments(
        torch.as_tensor(np.array(state_j.obstacles.aabb)),
        torch.ones(3, dtype=torch.bool))
    for f in segs_j._fields:
        got, want = getattr(segs_t, f).numpy(), getattr(segs_j, f)
        if want.dtype == bool:
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=f)
        np.testing.assert_array_equal(getattr(same_corners, f).numpy(),
                                      want, err_msg=f)
    assert int(segs_t.valid.sum()) >= 12
    _assert_ped_obs_exact(obs_t, obs_j)


def test_orca_teacher_forced_steps(orca_envs):
    """Six steps, each from the JAX state with the JAX step's beep draw
    injected; robots 0 and 2 beep (v_y > 0), and peds stand within the
    beep radius of a heeded beep (the ERVO evacuation term).  The crowd
    agrees within ORCA_TOL, beeps, waypoint indices and gait phases
    exactly, and every observation surface exactly given the same (JAX)
    state."""
    env_j, env_t = orca_envs
    rng = np.random.default_rng(22)
    with jax.enable_x64(False):
        state_j, _ = env_j.reset(jax.random.PRNGKey(23))
    n = env_t.cfg.robot.total
    moved = beeped = 0.0
    for step in range(6):
        acts = np.stack([rng.uniform(0.1, 0.6, n), rng.uniform(-0.9, 0.9, n),
                         np.array([1.0, 0.0, 1.0])], -1).astype(np.float32)
        state_in = world_state_from_numpy(_np(state_j))
        u = _beep_draw(state_j, n)
        adv_j, obs_j = _jax_advance_observe(env_j, state_j, acts)
        with jax.enable_x64(False):
            state_j, _, rew_j, done_j, info_j = env_j.step(state_j, acts)
        st_t, obs_t, rew_t, done_t, info_t = env_t.step_fn(
            state_in, torch.as_tensor(acts), beep_u=u)
        pj, pt = _np(state_j.peds), st_t.peds
        np.testing.assert_allclose(pt.pos.numpy(), pj.pos, rtol=0,
                                   atol=ORCA_TOL["pos"])
        np.testing.assert_allclose(pt.vel.numpy(), pj.vel, rtol=0,
                                   atol=ORCA_TOL["vel"])
        for f in ("traj_idx", "gait_state"):
            np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                          getattr(pj, f), err_msg=f)
        np.testing.assert_array_equal(info_t["beeps"].numpy(),
                                      np.asarray(info_j["beeps"]))
        np.testing.assert_array_equal(
            st_t.crowd_aux.robot_vel.numpy(),
            np.asarray(state_j.crowd_aux.robot_vel))
        _, obs_f = env_t._observe(world_state_from_numpy(_np(adv_j)))
        _assert_ped_obs_exact(obs_f, obs_j)
        np.testing.assert_array_equal(rew_t.numpy(), np.asarray(rew_j))
        np.testing.assert_array_equal(done_t.numpy(), np.asarray(done_j))
        moved += float(np.abs(pj.pos - state_in.peds.pos.numpy()).sum())
        # peds within beep_r of a robot whose beep the crowd heeds
        gap = np.linalg.norm(state_in.peds.pos.numpy()[:, None]
                             - state_in.robots.pose.numpy()[None, :, :2],
                             axis=-1)
        beeped += float(((gap <= 1.5) & info_t["beeps"].numpy()[None]).sum())
    assert moved > 0 and beeped > 0


def test_orca_fallback_segments_without_split(orca_envs):
    """A state whose reset built no split segments (segs None) solves
    against the raw rectangle edges (nav_env.py:704-712), as the JAX env
    does."""
    env_j, env_t = orca_envs
    with jax.enable_x64(False):
        state_j, _ = env_j.reset(jax.random.PRNGKey(24))
        state_j = state_j._replace(
            obstacles=state_j.obstacles._replace(segs=None))
        adv_j, _, _ = jax.jit(env_j.advance_fn)(
            state_j, jax.numpy.zeros((3, 3)))
    state_t = world_state_from_numpy(_np(state_j))
    assert state_t.obstacles.segs is None
    adv_t, _, _ = env_t.advance_fn(state_t, torch.zeros((3, 3)),
                                   beep_u=_beep_draw(state_j, 3))
    np.testing.assert_allclose(adv_t.peds.pos.numpy(),
                               np.asarray(adv_j.peds.pos), rtol=0,
                               atol=ORCA_TOL["pos"])


def test_reset_with_carry_matches_jax(orca_envs):
    """reset(carry=) keeps the previous episode's vw_last1, ped velocities,
    gait phase and residual and the robots' crowd velocities."""
    env_j, env_t = orca_envs
    with jax.enable_x64(False):
        prev, _ = env_j.reset(jax.random.PRNGKey(25))
        for _ in range(3):
            prev, *_ = env_j.step(prev, np.tile(
                np.asarray([[0.4, 0.3, 1.0]], np.float32), (3, 1)))
        prev = prev._replace(crowd_aux=prev.crowd_aux._replace(
            robot_vel=prev.crowd_aux.robot_vel + 0.25))
        key = jax.random.PRNGKey(26)
        state_j, obs_j = env_j.reset(key, carry=prev)
    assert float(np.abs(np.asarray(prev.peds.vel)).max()) > 0
    state_t, obs_t = env_t.reset(_jax_sample(env_j, key),
                                 carry=world_state_from_numpy(_np(prev)))
    want = _np(state_j)
    for f in state_t.peds._fields:
        np.testing.assert_array_equal(getattr(state_t.peds, f).numpy(),
                                      getattr(want.peds, f), err_msg=f)
    for f in ("vw_last0", "vw_last1", "pose"):
        np.testing.assert_array_equal(getattr(state_t.robots, f).numpy(),
                                      getattr(want.robots, f), err_msg=f)
    np.testing.assert_array_equal(state_t.crowd_aux.robot_vel.numpy(),
                                  want.crowd_aux.robot_vel)
    _assert_ped_obs_exact(obs_t, obs_j)


# ---------------------------------------------------------------------
# the shipped configs that need the ORCA crowds or the circle/view poses
# ---------------------------------------------------------------------

SHIPPED = ("test.yaml", "ervo_crowd.yaml", "circle.yaml", "random.yaml")


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_config_resets_and_steps(name):
    """The config read with yaml in the test (the package reads no yaml),
    its views shrunk to 3 m at 0.05 m and 96 beams to keep the CPU quick;
    crowd model, pose types, obstacles and beeps as shipped."""
    import os

    import yaml

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "img_env_tpu", "configs", name)
    with open(path) as f:
        d = yaml.safe_load(f)
    d.update(view_map={"resolution": 0.05, "width": 3, "height": 3},
             range_total=96)
    env = NavEnv(EnvConfig.from_dict(d), "cpu", seed=3)
    state, obs = env.reset()
    n, m = env.cfg.robot.total, env.cfg.ped_sim.total
    start = state.peds.pos.clone()
    act = torch.zeros((n, 3))
    act[:, 0], act[:, 2] = 0.3, 1.0
    for _ in range(2):
        state, obs, reward, done, info = env.step(state, act)
    assert obs.sensor_maps.shape == (n, 48, 48)
    assert obs.ped_maps.shape == (n, 3, 48, 48)
    for x in (obs.lasers, obs.ped_vector_states, state.peds.pos,
              state.peds.vel):
        assert bool(torch.isfinite(x).all())
    assert state.peds.pos.shape == (m, 2)
    assert float((state.peds.pos - start).abs().max()) > 0
    if env.scene_type in ("rvoscene", "ervoscene"):
        assert state.obstacles.segs is not None
