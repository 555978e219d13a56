"""The port's scene batch against its own scene loop, per-scene static
maps, and the scene-batched MPC act against the JAX package's vmapped act,
on ``tests/test_torch_multiscene.py``'s configs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.parallel.batched_env import BatchedNavEnv as JaxBatchedNavEnv
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.core.convert import world_state_from_numpy
from img_env_tpu_torch.parallel import BatchedNavEnv
from tests.test_multiscene_flat import OBS_FIELDS
from tests.test_torch_multiscene import (
    ACTS,
    CASES,
    S,
    STEPS,
    _np,
    _pair,
    assert_obs_exact,
    cfg_dict,
    port_cfg,
)


def _run_port(env):
    states, obs = env.reset(S)
    seq = [obs]
    for _ in range(STEPS):
        states, obs, *_ = env.step(states, torch.as_tensor(ACTS),
                                   beep_u=torch.zeros((S, 2)))
        seq.append(obs)
    seq.append(env.reset(S, carry=states)[1])
    return seq


@pytest.mark.parametrize("args", CASES,
                         ids=["pedscene", "rvoscene", "none",
                              "pedscene-nolaser"])
def test_flat_path_matches_scene_loop(args):
    """The port's flat path against its own scene-by-scene loop through
    the single-scene NavEnv (``legacy_vmap``), free-running from the same
    seed (the S layouts drawn in order, then a carried re-reset): every
    surface of every step bit-identical."""
    flat = BatchedNavEnv(port_cfg(args), "cpu", seed=3)
    legacy = BatchedNavEnv(port_cfg(args), "cpu", seed=3, legacy_vmap=True)
    for t, (got, want) in enumerate(zip(_run_port(flat),
                                        _run_port(legacy))):
        for f in OBS_FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), (t, f)


def test_per_scene_static_maps():
    """reset(static_maps=): each scene on its own base map (a block of
    occupied cells in a different place per scene), bit-exact, on the
    pedscene config."""
    p = _pair(CASES[0])
    base = np.asarray(p.j.core.statics.static_map)
    maps = np.repeat(base[None], S, axis=0)
    for k in range(S):
        maps[k, 20 + 12 * k:28 + 12 * k, 30:50] = 0
    states_j, obs_j, (states_t, obs_t) = p.reset(
        jax.random.split(jax.random.PRNGKey(4), S), static_maps=maps)
    np.testing.assert_array_equal(states_t.obs_map.numpy(),
                                  np.asarray(states_j.obs_map))
    assert not np.array_equal(np.asarray(states_j.obs_map[0]),
                              np.asarray(states_j.obs_map[1]))
    assert_obs_exact(obs_t, obs_j)


def test_mesh_is_not_ported():
    """The mesh is ported: a batch over a mesh of one rank (a gloo world
    of one) equals the unsharded batch bit for bit after a reset and a
    step (two ranks: tests/test_torch_multidev.py)."""
    import torch.distributed as dist

    from img_env_tpu_torch.parallel.mesh import make_mesh

    started = not dist.is_initialized()
    try:
        cfg = port_cfg(CASES[2])
        envs = [BatchedNavEnv(cfg, "cpu", seed=3, mesh=m)
                for m in (make_mesh(device_type="cpu"), None)]
        outs = []
        for env in envs:
            states, obs = env.reset(2)
            actions = torch.full((2, cfg.robot.total, 3), 0.3)
            outs.append((obs, env.step(states, actions)[1]))
        for got, want in zip(*outs):
            for f in OBS_FIELDS:
                assert torch.equal(getattr(got, f), getattr(want, f)), f
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------
# the MPC act over S scenes: one batched_mppi solve for all S*N robots
# ---------------------------------------------------------------------

K, H = 128, 12


def test_act_scenes_matches_vmapped_jax_act():
    """The port's scene-batched act (one solve over S*N robots) against
    ``jax.vmap(MpcController.act_fn)`` over the scenes (bench.py:462) with
    the JAX controller's own noise injected, after two crowd steps, within
    F12's float32 tolerances (tests/test_torch_mpc.py): actions 5e-4, the
    shifted plan 1e-3, costs rtol 1e-4; ``avoid_k`` 1, so each robot
    avoids the nearest other robot of its scene (top-k within the scene;
    the sensor-group config has 3 robots a scene).  The port's per-scene
    ``act_fn`` gives the same result bit for bit, with ``avoid_k`` 1 and
    with 16 (every other robot of the scene)."""
    from img_env_tpu.mpc import mppi as jmppi
    from img_env_tpu.mpc.controller import MpcController as JaxMpc
    from img_env_tpu_torch.mpc import mppi
    from img_env_tpu_torch.mpc.controller import MpcController, MpcState
    from tests.test_torch_hetero_sensors import hetero_cfg_dict
    from tests.test_torch_mpc import _jax_noise

    d = hetero_cfg_dict(True)
    d["ped_sim"] = cfg_dict()["ped_sim"]
    s = 3
    mcfg = dict(horizon=H, samples=K, avoid_k=1)
    keys = jax.random.split(jax.random.PRNGKey(7), s)
    acts = np.tile(np.asarray([[0.4, 0.2, 0.0], [0.3, -0.3, 0.0],
                               [0.5, 0.1, 0.0]], np.float32), (s, 1, 1))
    with jax.enable_x64(False):
        env_j = JaxBatchedNavEnv(JaxEnvConfig.from_dict(d), mesh=None)
        states_j, _ = env_j.reset(keys)
        for _ in range(2):
            states_j, *_ = env_j.step(states_j, acts)
        ctl_j = JaxMpc(env_j.core, jmppi.MppiConfig(**mcfg))
        kk = jax.random.split(jax.random.PRNGKey(8), s)
        ms_j = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (s,) + x.shape), ctl_j.init_state())
        noise = np.stack([np.array(_jax_noise(k, 3)) for k in kk])
        a_j, ms_j, c_j = jax.jit(jax.vmap(ctl_j.act_fn))(kk, states_j, ms_j)
    env_t = BatchedNavEnv(EnvConfig.from_dict(d), "cpu")
    ctl_t = MpcController(env_t.core, mppi.MppiConfig(**mcfg))
    states_t = world_state_from_numpy(_np(states_j))
    a_t, ms_t, c_t = ctl_t.act_scenes(states_t, ctl_t.init_scenes_state(s),
                                      torch.as_tensor(noise))
    assert a_t.shape == (s, 3, 3) and c_t.shape == (s, 3)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=5e-4,
                               rtol=0)
    np.testing.assert_allclose(ms_t.nominal.numpy(),
                               np.asarray(ms_j.nominal), atol=1e-3, rtol=0)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-4)
    for avoid_k in (1, 16):
        ctl_k = MpcController(env_t.core, mppi.MppiConfig(
            **dict(mcfg, avoid_k=avoid_k)))
        a_k, ms_k, c_k = ctl_k.act_scenes(
            states_t, ctl_k.init_scenes_state(s), torch.as_tensor(noise))
        for k in range(s):
            one = jax.tree_util.tree_map(lambda x: x[k], states_t)
            a1, ms1, c1 = ctl_k.act_fn(
                one, MpcState(torch.zeros((3, H, 2))),
                torch.as_tensor(noise[k]))
            assert torch.equal(a1, a_k[k]) and torch.equal(c1, c_k[k])
            assert torch.equal(ms1.nominal, ms_k.nominal[k])
