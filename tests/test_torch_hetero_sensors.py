"""Per-robot sensor placements (sensor groups) of the port against the JAX
env: ``tests/test_hetero_sensors.py``'s 3 robots in 2 groups (offsets
(0.15, 0) and (-0.1, 0.08)) with one circle ped, with and without lasers;
a case where robots of different groups overlap, so that the fill's
self-exclusion depends on each robot's in-scene id; and the grouped pass
under S=3 scenes against the JAX batch.  Every surface bit-exact (the
vector states as ``tests/test_torch_env.py`` holds them)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.env.nav_env import NavEnv as JaxNavEnv
from img_env_tpu.parallel.batched_env import BatchedNavEnv as JaxBatchedNavEnv
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.core.convert import world_state_from_numpy
from img_env_tpu_torch.env.nav_env import NavEnv
from img_env_tpu_torch.ops import polar
from img_env_tpu_torch.parallel import BatchedNavEnv
from tests.test_torch_env import (
    _assert_ped_obs_exact,
    _assert_vector_states,
    _jax_programs,
    _jax_sample,
    _jax_step,
    _np,
)
from tests.test_torch_multiscene import assert_obs_exact, jax_samples

SENSORS = [[0.15, 0.0], [-0.1, 0.08], [0.15, 0.0]]   # 2 groups, 3 robots
ROBOT_FIX = [[3.0, 3.0, 0.4], [5.5, 5.0, -1.2], [6.5, 3.5, 2.2]]
PED_FIX = [[4.5, 4.0, 0.0]]


def hetero_cfg_dict(use_laser=True):
    """tests/test_hetero_sensors.py's config."""
    return {
        "env_name": "hetero", "control_hz": 0.4, "use_laser": use_laser,
        "range_total": 64, "state_dim": 3, "max_ped": 1,
        "laser_norm": False, "laser_max": 10.0,
        "robot": {"total": 3, "shape": ["circle"] * 3,
                  "size": [[0, 0, 0.17]] * 3,
                  "sensor_cfgs": SENSORS,
                  "begin_poses_type": ["fix"] * 3,
                  "begin_poses": ROBOT_FIX,
                  "target_poses_type": ["fix"] * 3,
                  "target_poses": [[8.0, 8.0, 0], [1.5, 8.0, 0],
                                   [8.0, 1.5, 0]]},
        "object": {"total": 0},
        "ped_sim": {"total": 1, "type": "", "max_speed": [0.5],
                    "shape": ["circle"], "size": [[0, 0, 0.25]],
                    "begin_poses_type": ["fix"], "begin_poses": PED_FIX,
                    "target_poses_type": ["fix"], "target_poses": PED_FIX},
        "global_map": {"map_file": "room_10.png", "resolution": 0.1},
        "view_map": {"resolution": 0.05, "width": 3.0, "height": 3.0},
        "sensor_mode": "parity",
    }


@functools.lru_cache(maxsize=None)
def _pair(use_laser):
    """The JAX env and the port's on the CPU, one pair per config, shared
    by this module's tests."""
    d = hetero_cfg_dict(use_laser)
    with jax.enable_x64(False):
        env_j = JaxNavEnv(JaxEnvConfig.from_dict(d))
    return env_j, NavEnv(EnvConfig.from_dict(d), "cpu")


def _check_reset_and_steps(env_j, env_t):
    key = jax.random.PRNGKey(0)
    with jax.enable_x64(False):
        state_j, obs_j = env_j.reset(key)
    _, obs_t = env_t.reset(_jax_sample(env_j, key))
    _assert_ped_obs_exact(obs_t, obs_j)
    _assert_vector_states(obs_t.vector_states.numpy(), obs_j.vector_states)
    acts = np.asarray([[0.4, 0.2, 0.0], [0.3, -0.3, 0.0], [0.5, 0.1, 0.0]],
                      np.float32)
    for _ in range(3):
        adv_j, obs_j, state_j = _jax_step(env_j, state_j, acts)
        _, obs_f = env_t._observe(world_state_from_numpy(_np(adv_j)))
        _assert_ped_obs_exact(obs_f, obs_j)
    return obs_t


@pytest.mark.parametrize("use_laser", [True, False])
def test_hetero_env_matches_jax(use_laser):
    env_j, env_t = _pair(use_laser)
    groups = env_t.statics.sensor_groups
    assert [g.idx.tolist() for g in groups] == [[0, 2], [1]]
    assert len(env_t.group_tables) == 2
    assert (env_t.tables.painter is None) == (not use_laser)
    _check_reset_and_steps(env_j, env_t)


def test_overlapping_groups_fill_reads_in_scene_ids():
    """Robot 1 (group 1, the only member) stands on robot 0's footprint
    (group 0) and robot 2 (group 0) beside them: cells that one robot alone
    covers are free for that robot only.  The port's grouped pass of that
    state equals the JAX env's, and feeding K2's twin group-local ids
    instead of the in-scene ones (robot 2 would exclude robot 1's cells)
    changes the fill."""
    env_j, env_t = _pair(True)
    with jax.enable_x64(False):
        state_j, _ = env_j.reset(jax.random.PRNGKey(0))
        state_j = state_j._replace(robots=state_j.robots._replace(
            pose=jnp.asarray([[3.0, 3.0, 0.4], [3.12, 3.05, -1.2],
                              [3.3, 3.3, 2.2]], jnp.float32)))
        _, obs_j = _jax_programs(env_j)[2](state_j, env_j.sensor_tables)
    state = world_state_from_numpy(_np(state_j))
    _, obs_t = env_t._observe(state)
    _assert_ped_obs_exact(obs_t, obs_j)
    layers = env_t._layers(world_state_from_numpy(
        jax.tree_util.tree_map(lambda x: np.asarray(x)[None],
                               _np(state_j))))
    g, t = env_t.statics.sensor_groups[0], env_t.group_tables[0]
    poses = state.robots.pose[t.idx]
    right = polar.fill_sorted(g.polar, t.polar, layers.packed, poses,
                              env_t.statics.resolution, t.rids)
    wrong = polar.fill_sorted(g.polar, t.polar, layers.packed, poses,
                              env_t.statics.resolution, None)
    assert int((right != wrong).sum()) > 0


def test_hetero_multiscene_matches_jax():
    """The grouped flat pass under S=3 scenes: the port's batch against the
    JAX batch through reset and two teacher-forced steps."""
    d = hetero_cfg_dict(True)
    s = 3
    keys = jax.random.split(jax.random.PRNGKey(5), s)
    acts = np.tile(np.asarray([[0.4, 0.2, 0.0], [0.3, -0.3, 0.0],
                               [0.5, 0.1, 0.0]], np.float32), (s, 1, 1))
    with jax.enable_x64(False):
        env_j = JaxBatchedNavEnv(JaxEnvConfig.from_dict(d), mesh=None)
        states_j, obs_j = env_j.reset(keys)
        core = env_j.core
        advance = jax.jit(jax.vmap(core.advance_fn))
        observe = jax.jit(lambda x: core._observe_multi(x, None))
    env_t = BatchedNavEnv(EnvConfig.from_dict(d), "cpu")
    _, obs_t = env_t.reset(jax_samples(env_j, keys))
    assert_obs_exact(obs_t, obs_j)
    for _ in range(2):
        with jax.enable_x64(False):
            adv_j, _, _ = advance(states_j, jnp.asarray(acts))
            states_j, obs_j = observe(adv_j)
        _, obs_f = env_t.core.observe_scenes(
            world_state_from_numpy(_np(adv_j)))
        assert_obs_exact(obs_f, obs_j)
    assert obs_f.sensor_maps.shape == (s, 3, 48, 48)
