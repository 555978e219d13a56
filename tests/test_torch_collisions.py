"""Collision codes of the torch port vs the JAX NavEnv in a dense crowd.

16 robots drive among 24 SFM leg pedestrians and 4 obstacles in a 10 m
room, from one reset (the JAX sampler's layout injected into the port) and
with the same injected actions.  Each step starts from the JAX state
(teacher forcing, as tests/test_torch_env.py does): the port's own step
(kinematics, crowd, raster) and its observation of the JAX package's next
state both give the JAX package's per-step collision codes, code 2 (a
pedestrian) included.
"""

import jax
import numpy as np
import torch

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.env.nav_env import NavEnv as JaxNavEnv
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.core.convert import world_state_from_numpy
from img_env_tpu_torch.env.nav_env import NavEnv

from tests.test_torch_env import _jax_sample, _np, ped_cfg_dict

N_ROB, N_PED, STEPS = 16, 24, 6


def test_collision_codes_in_a_dense_crowd():
    d = ped_cfg_dict(n_rob=N_ROB, n_ped=N_PED, n_obs=4)
    d["ped_sim"]["shape"] = ["leg"]
    d["ped_sim"]["size"] = [[0, 0.1, 0.1]]
    with jax.enable_x64(False):
        env_j = JaxNavEnv(JaxEnvConfig.from_dict(d))
    env_t = NavEnv(EnvConfig.from_dict(d), "cpu")
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(False):
        state_j, _ = env_j.reset(key)
    state_t, _ = env_t.reset(_jax_sample(env_j, key))
    np.testing.assert_array_equal(state_t.robots.pose.numpy(),
                                  np.asarray(state_j.robots.pose))
    rng = np.random.default_rng(0)
    codes = []
    for _ in range(STEPS):
        acts = np.stack([rng.uniform(0.3, 0.6, N_ROB),
                         rng.uniform(-0.9, 0.9, N_ROB),
                         np.zeros(N_ROB)], -1).astype(np.float32)
        state_in = world_state_from_numpy(_np(state_j))
        with jax.enable_x64(False):
            state_j, obs_j, _, _, _ = env_j.step(state_j, acts)
        st_t, obs_t, _, _, _ = env_t.step_fn(state_in, torch.as_tensor(acts))
        # the JAX state after the step: its poses, codes latched
        _, obs_f = env_t._observe(world_state_from_numpy(_np(state_j)))
        want = np.asarray(obs_j.is_collisions)
        np.testing.assert_array_equal(obs_f.is_collisions.numpy(), want)
        np.testing.assert_array_equal(obs_t.is_collisions.numpy(), want)
        np.testing.assert_array_equal(st_t.robots.collision.numpy(),
                                      np.asarray(state_j.robots.collision))
        codes.append(want)
    codes = np.stack(codes)
    assert (codes == 2).any(), np.bincount(codes.ravel(), minlength=4)
