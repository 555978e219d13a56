"""The ``dataset`` crowd (ETH/UCY trajectory replay) of the torch port vs
the JAX package: the csv loader's arrays, the replay gather, and the
replayed env scene.

The replay is a gather, so ped positions and velocities are exact; ped
yaws are atan2 of the velocities, where XLA's float32 atan2 and torch's
differ in the last bit for ~16% of arguments, so yaws agree within 1e-6.
The observations are exact given the same state.
"""

import os

import jax
import numpy as np
import pytest
import torch

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.crowd import common as jcommon
from img_env_tpu.datasets import pedestrians as jped
from img_env_tpu.env.nav_env import NavEnv as JaxNavEnv
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.core.convert import world_state_from_numpy
from img_env_tpu_torch.crowd import common
from img_env_tpu_torch.datasets import pedestrians as ped
from img_env_tpu_torch.env.nav_env import NavEnv

from tests.test_torch_env import (
    _assert_ped_obs_exact,
    _jax_advance_observe,
    _jax_sample,
    _np,
    ped_cfg_dict,
)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "eth_world_fixture.csv")
M = 6


def _arrays(mod, **kw):
    cfg = mod.PedDatasetConfig(fps=15, control_hz=0.4, swapxy=True,
                               offset=(5.0, 5.0, 0.0), scale_x=0.7,
                               scale_y=0.7)
    return mod.build_world_arrays(mod.load_trajectory_csv(FIXTURE), 0, M,
                                  cfg, **kw)


@pytest.mark.parametrize("pad", [{}, {"pad_peds": 8, "pad_time": 12}])
def test_eth_loader_matches_jax(pad):
    got, want = _arrays(ped, **pad), _arrays(jped, **pad)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ped.load_trajectory_csv(FIXTURE),
                                  jped.load_trajectory_csv(FIXTURE))


def test_dataset_replay_exact():
    """Clamped per-ped indices: before, inside and past each series."""
    rng = np.random.default_rng(0)
    traj = rng.uniform(0, 10, (5, 7, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (5, 7, 2)).astype(np.float32)
    length = np.array([1, 3, 7, 5, 2], np.int32)
    for step in (0, 2, 4, 9):
        with jax.enable_x64(False):
            want = jax.jit(jcommon.dataset_replay)(np.int32(step), traj, vel,
                                                   length)
        got = common.dataset_replay(torch.tensor(step, dtype=torch.int32),
                                    *map(torch.as_tensor, (traj, vel, length)))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=0, atol=1e-6)


def dataset_cfg_dict():
    d = ped_cfg_dict(n_rob=2, n_ped=M, n_obs=2)
    d["ped_sim"].update(type="dataset", shape=["circle"],
                        size=[[0.0, 0.0, 0.17]], max_speed=[1.0])
    d["max_ped"] = M
    return d


def test_dataset_scene_replays_the_fixture():
    """Reset from the fixture's arrays, then 20 steps from the JAX state:
    the peds replay frame k at step k exactly, and every observation
    surface equals the JAX env's."""
    traj, vel, length = _arrays(jped)
    assert traj.shape[1] >= 20
    d = dataset_cfg_dict()
    with jax.enable_x64(False):
        env_j = JaxNavEnv(JaxEnvConfig.from_dict(d))
    env_t = NavEnv(EnvConfig.from_dict(d), "cpu")
    key = jax.random.PRNGKey(31)
    with jax.enable_x64(False):
        state_j, obs_j = env_j.reset(key, dataset=(traj, vel, length))
    state_t, obs_t = env_t.reset(_jax_sample(env_j, key),
                                 dataset=(traj, vel, length))
    want = _np(state_j.peds)
    for f in state_t.peds._fields:
        tol = 1e-6 if f == "yaw" else 0
        np.testing.assert_allclose(getattr(state_t.peds, f).numpy(),
                                   getattr(want, f), rtol=0, atol=tol,
                                   err_msg=f)
    np.testing.assert_array_equal(state_t.peds.pos.numpy(), traj[:, 0])
    _assert_ped_obs_exact(obs_t, obs_j)
    acts = np.tile(np.asarray([[0.3, 0.2, 0.0]], np.float32), (2, 1))
    occupied = 0
    for k in range(20):
        state_in = world_state_from_numpy(_np(state_j))
        adv_j, obs_j = _jax_advance_observe(env_j, state_j, acts)
        with jax.enable_x64(False):
            state_j, *_ = env_j.step(state_j, acts)
        st_t, obs_t, *_ = env_t.step_fn(state_in, torch.as_tensor(acts))
        np.testing.assert_array_equal(st_t.peds.pos.numpy(), traj[:, k])
        np.testing.assert_array_equal(st_t.peds.pos.numpy(),
                                      np.asarray(state_j.peds.pos))
        np.testing.assert_array_equal(st_t.peds.vel.numpy(),
                                      np.asarray(state_j.peds.vel))
        np.testing.assert_allclose(st_t.peds.yaw.numpy(),
                                   np.asarray(state_j.peds.yaw), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(st_t.peds.gait_state.numpy(),
                                      np.asarray(state_j.peds.gait_state))
        _, obs_f = env_t._observe(world_state_from_numpy(_np(adv_j)))
        _assert_ped_obs_exact(obs_f, obs_j)
        occupied += int(obs_f.ped_maps[:, 0].sum())
    assert occupied > 0
