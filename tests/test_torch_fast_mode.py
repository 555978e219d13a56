"""``sensor_mode='fast'`` of the port against the JAX env: the same polar
pipeline on a view grid coarsened by ``fast_sensor_scale`` (2 and 3; with
and without lasers), on ``tests/test_parallel.py``'s tiny config (2 robots
among 1 ORCA circle ped in ``room_10.png``, 6 m views at 0.05 m, 64
beams).  The JAX fast path is the parity pipeline on a coarser grid, so it
is deterministic: the reset and three teacher-forced steps are bit-exact on
every sensor, collision and ped surface, the vector states as
``tests/test_torch_env.py`` holds them."""

import jax
import numpy as np
import pytest
import torch

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.env.nav_env import NavEnv as JaxNavEnv
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.core.convert import world_state_from_numpy
from img_env_tpu_torch.env.nav_env import NavEnv
from tests.test_torch_env import (
    _assert_ped_obs_exact,
    _assert_vector_states,
    _jax_sample,
    _jax_step,
    _np,
)

BOX = [[1.0, 9.0, 1.0, 9.0]]


def tiny_cfg_dict(robots=2, peds=1, **kw):
    """tests/test_parallel.py's tiny_cfg, 64 beams."""
    d = {
        "robot": {"total": robots, "size": [[0.0, 0.0, 0.17]],
                  "begin_poses_type": ["range"], "begin_poses": BOX,
                  "target_poses_type": ["range"], "target_poses": BOX},
        "ped_sim": {"total": peds, "type": "rvoscene", "max_speed": [0.5],
                    "shape": ["circle"], "size": [[0.0, 0.0, 0.17]],
                    "begin_poses_type": ["range"], "begin_poses": BOX,
                    "target_poses_type": ["range"], "target_poses": BOX},
        "global_map": {"map_file": "room_10.png", "resolution": 0.1},
        "view_map": {"resolution": 0.05, "width": 6.0, "height": 6.0},
        "range_total": 64,
        "max_ped": max(peds, 1),
    }
    d.update(kw)
    return d


@pytest.mark.parametrize("scale,use_laser", [(2, True), (3, True),
                                             (3, False)])
def test_fast_mode_matches_jax(scale, use_laser):
    d = tiny_cfg_dict(sensor_mode="fast", fast_sensor_scale=scale,
                      use_laser=use_laser)
    with jax.enable_x64(False):
        env_j = JaxNavEnv(JaxEnvConfig.from_dict(d))
    env_t = NavEnv(EnvConfig.from_dict(d), "cpu")
    ps = env_t.statics.polar
    assert ps.params.hpx == 120 // scale
    assert ps.params.resolution == pytest.approx(0.05 * scale)
    assert ps.n_fill_slots % 8 == 0 and ps.n_slots % 8 == 0
    key = jax.random.PRNGKey(scale)
    with jax.enable_x64(False):
        state_j, obs_j = env_j.reset(key)
    _, obs_t = env_t.reset(_jax_sample(env_j, key))
    _assert_ped_obs_exact(obs_t, obs_j)
    _assert_vector_states(obs_t.vector_states.numpy(), obs_j.vector_states)
    rng = np.random.default_rng(scale)
    for _ in range(3):
        acts = np.stack([rng.uniform(0.1, 0.6, 2), rng.uniform(-0.9, 0.9, 2),
                         np.zeros(2)], -1).astype(np.float32)
        adv_j, obs_j, state_j = _jax_step(env_j, state_j, acts)
        _, obs_f = env_t._observe(world_state_from_numpy(_np(adv_j)))
        _assert_ped_obs_exact(obs_f, obs_j)
        _assert_vector_states(obs_f.vector_states.numpy(),
                              obs_j.vector_states)
    if use_laser:
        assert float(obs_t.lasers.min()) < 6.0     # some beam hits


def test_fast_grid_slot_counts_suit_the_kernels():
    """bench200's fast grid (400 -> 133 px at 0.045 m): the sorted slot
    counts are multiples of 128 (K2 takes multiples of 8, K3 of 4)."""
    from img_env_tpu_torch.ops import polar
    from img_env_tpu_torch.ops.view import ViewParams

    vp = ViewParams(hpx=133, wpx=133, resolution=0.045, half=3.0,
                    angle_begin=-np.pi / 2, angle_end=np.pi / 2,
                    min_dist=0.0, max_dist=6.0, range_total=960,
                    use_laser=True)
    ps = polar.PolarStatics.build(vp, (0.0, 0.0))
    assert ps.n_fill_slots % 128 == 0 and ps.n_slots % 128 == 0
    assert 0 < ps.n_fill_slots < ps.n_slots
    assert int(ps.gates_sorted.sum()) > 0


def test_fast_mode_env_shapes():
    env = NavEnv(EnvConfig.from_dict(tiny_cfg_dict(
        robots=2, peds=2, sensor_mode="fast", fast_sensor_scale=2,
        range_total=32)), "cpu", seed=1)
    state, obs = env.reset()
    for _ in range(3):
        state, obs, *_ = env.step(state, torch.tensor([[0.3, 0.1, 0.0]] * 2))
    assert obs.sensor_maps.shape == (2, 48, 48)
    assert bool(torch.isfinite(obs.sensor_maps).all())
    assert bool(torch.isfinite(obs.lasers).all())
