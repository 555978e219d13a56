"""The port's scene batch (``img_env_tpu_torch.parallel.BatchedNavEnv``)
against the JAX package's, on ``tests/test_multiscene_flat.py``'s configs:
S=4 scenes of 2 robots, 3 rectangles and 0 or 2 leg peds in ``room_10.png``,
3 m views at 0.05 m, 64 beams.

Both packages run in float32 (the JAX side jitted under
``jax.enable_x64(False)``); on the CPU the port runs its kernels' twins.
The JAX samples are injected (torch cannot reproduce threefry draws), and
every step starts from the JAX states (teacher forcing), as
``test_torch_env.py`` does: the port's own step gives the JAX robot states
bit for bit and the crowd within its stated tolerances (F15, F16), and
the port's observation of the JAX states after the crowd and robot
dynamics is bit-exact on every surface.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.env.sampler import sample_scenario_retry
from img_env_tpu.parallel.batched_env import BatchedNavEnv as JaxBatchedNavEnv
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.core.convert import world_state_from_numpy
from img_env_tpu_torch.env.sampler import ScenarioSample
from img_env_tpu_torch.parallel import BatchedNavEnv
from tests.test_multiscene_flat import OBS_FIELDS
from tests.test_torch_env import _assert_vector_states

S = 4
STEPS = 3
CASES = [(2, "pedscene", True), (2, "rvoscene", True), (0, "", True),
         (2, "pedscene", False)]
ACTS = np.tile(np.asarray([[0.4, 0.3, 0.0], [0.5, -0.2, 0.0]], np.float32),
               (S, 1, 1))
# crowd floats (pos, vel): SFM within float32 rounding, except the first
# step's velocities, whose theta-sign term starts from rest (F15: the
# direction of a near-zero angle is rounding noise, so a velocity can flip
# its social-force component; the positions agree); float32 ORCA's LP
# conditioning (F16)
CROWD_TOL = {"pedscene": (1e-5, 1e-5), "rvoscene": (1e-3, 2e-3)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def cfg_dict(peds=2, scene="pedscene", use_laser=True):
    """``tests/test_multiscene_flat.py``'s config."""
    box = [[1.0, 9.0, 1.0, 9.0]]
    d = {
        "robot": {"total": 2, "begin_poses_type": ["range"],
                  "begin_poses": box, "target_poses_type": ["range"],
                  "target_poses": box},
        "object": {"total": 3, "shape": ["rectangle"],
                   "size_range": [[0.1, 0.4, 0.1, 0.4]],
                   "poses_type": ["range"], "poses": [[2.0, 8.0, 2.0, 8.0]]},
        "ped_sim": {"total": peds, "type": scene, "max_speed": [0.5],
                    "shape": ["leg"], "size": [[0.0, 0.1, 0.1]],
                    "begin_poses_type": ["range"], "begin_poses": box,
                    "target_poses_type": ["range"], "target_poses": box},
        "global_map": {"resolution": 0.1, "map_file": "room_10.png"},
        "view_map": {"resolution": 0.05, "width": 3, "height": 3},
        "range_total": 64,
        "max_ped": 3,
        "use_laser": use_laser,
        "sensor_mode": "parity",
    }
    if peds == 0:
        d["ped_sim"] = {"total": 0, "type": ""}
    return d


def port_cfg(args):
    return EnvConfig.from_dict(cfg_dict(*args))


_SAMPLERS = {}


def _vmapped_sampler(spec):
    """One jitted sampler per distinct spec (the crowd type and the lasers
    leave it as it is, so most configs here share one program)."""
    leaves, tree = jax.tree_util.tree_flatten(spec)
    key = (str(tree),) + tuple((np.asarray(x).dtype.str, np.asarray(x).shape,
                                np.asarray(x).tobytes()) for x in leaves)
    if key not in _SAMPLERS:
        _SAMPLERS[key] = jax.jit(jax.vmap(lambda k: sample_scenario_retry(
            jax.random.split(k)[0], spec)))
    return _SAMPLERS[key]


def jax_samples(env_j, keys):
    """The JAX batch reset's scenario per scene key (nav_env.reset_state_fn),
    drawn under vmap as the batch reset draws them: XLA contracts the
    sampler's multiply-adds differently in a program of its own."""
    with jax.enable_x64(False):
        out = _vmapped_sampler(env_j.core.statics.sampler)(keys)
    return [ScenarioSample(*(torch.as_tensor(np.array(x[k])) for x in out))
            for k in range(keys.shape[0])]


def assert_obs_exact(got, want, fields=OBS_FIELDS):
    """Every surface bit-exact; the vector states' relative yaw within an
    ulp (glibc's atan2f, F17; tests/test_torch_env.py)."""
    for f in fields:
        g = np.asarray(getattr(got, f))
        if f == "vector_states":
            w = np.asarray(getattr(want, f))
            assert g.shape == w.shape
            _assert_vector_states(g.reshape(-1, g.shape[-1]),
                                  w.reshape(-1, w.shape[-1]))
            continue
        w = np.asarray(getattr(want, f))
        assert g.shape == w.shape, (f, g.shape, w.shape)
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=f)


class Pair:
    """The JAX batch (jitted entry points, and its advance and flat
    observation as separate programs for teacher forcing) and the port's
    batch on the CPU."""

    def __init__(self, args):
        with jax.enable_x64(False):
            self.j = JaxBatchedNavEnv(JaxEnvConfig.from_dict(cfg_dict(*args)),
                                      mesh=None)
            core = self.j.core
            self.advance = jax.jit(jax.vmap(core.advance_fn))
            self.observe = jax.jit(
                lambda s: core._observe_multi(s, core.sensor_tables))
        self.t = BatchedNavEnv(port_cfg(args), "cpu")

    def reset(self, keys, carry=None, **kw):
        with jax.enable_x64(False):
            states, obs = self.j.reset(keys, carry=carry, **kw)
        got = self.t.reset(jax_samples(self.j, keys),
                           carry=None if carry is None
                           else world_state_from_numpy(_np(carry)),
                           **{k: torch.as_tensor(np.asarray(v))
                              for k, v in kw.items()})
        return states, obs, got


@functools.lru_cache(maxsize=None)
def _pair(args):
    """One Pair per config, shared by this module's tests."""
    return Pair(args)


@pytest.fixture(params=CASES,
                ids=["pedscene", "rvoscene", "none", "pedscene-nolaser"])
def pair(request):
    return request.param, _pair(request.param)


def test_batch_matches_jax_through_steps_and_carried_reset(pair):
    args, p = pair
    scene = args[1]
    states_j, obs_j, (states_t, obs_t) = p.reset(
        jax.random.split(jax.random.PRNGKey(3), S))
    assert_obs_exact(obs_t, obs_j)
    for f in ("pose", "goal", "goal_yaw"):
        np.testing.assert_array_equal(getattr(states_t.robots, f).numpy(),
                                      np.asarray(getattr(states_j.robots, f)))
    np.testing.assert_array_equal(states_t.obs_map.numpy(),
                                  np.asarray(states_j.obs_map))
    for step in range(STEPS):
        state_in = world_state_from_numpy(_np(states_j))
        with jax.enable_x64(False):
            # the JAX batch step is this advance, then this observation
            adv_j, _, _ = p.advance(states_j, jnp.asarray(ACTS))
            states_j, obs_j = p.observe(adv_j)
        coll = np.asarray(obs_j.is_collisions)
        arr = np.asarray(obs_j.is_arrives)
        rew_j = (arr - coll).astype(np.float32)
        done_j = np.clip(np.clip(coll, -1, 1) + arr, 0, 1)
        # the port's own step from the same JAX states
        st_t, obs_t, rew_t, done_t, info = p.t.step(
            state_in, torch.as_tensor(ACTS))
        for f in ("pose", "vw_last0", "vw_last1", "vel_world", "arrive"):
            np.testing.assert_array_equal(
                getattr(st_t.robots, f).numpy(),
                np.asarray(getattr(states_j.robots, f)), err_msg=f)
        if scene:
            pos_tol, vel_tol = CROWD_TOL[scene]
            np.testing.assert_allclose(st_t.peds.pos.numpy(),
                                       np.asarray(states_j.peds.pos),
                                       rtol=0, atol=pos_tol)
            if step or scene != "pedscene":
                np.testing.assert_allclose(st_t.peds.vel.numpy(),
                                           np.asarray(states_j.peds.vel),
                                           rtol=0, atol=vel_tol)
        np.testing.assert_array_equal(rew_t.numpy(), np.asarray(rew_j))
        np.testing.assert_array_equal(done_t.numpy(), np.asarray(done_j))
        np.testing.assert_array_equal(info["beeps"].numpy(), 0)
        # the port's observation of the JAX states
        _, obs_f = p.t.core.observe_scenes(world_state_from_numpy(_np(adv_j)))
        assert_obs_exact(obs_f, obs_j)
    # carried re-reset (auto-reset): vw_last1, the gait and the crowd
    # velocities persist
    states2_j, obs2_j, (states2_t, obs2_t) = p.reset(
        jax.random.split(jax.random.PRNGKey(9), S), carry=states_j)
    assert_obs_exact(obs2_t, obs2_j)
    for f in ("vw_last0", "vw_last1"):
        np.testing.assert_array_equal(getattr(states2_t.robots, f).numpy(),
                                      np.asarray(getattr(states2_j.robots, f)))
    for f in states2_t.peds._fields:
        np.testing.assert_array_equal(getattr(states2_t.peds, f).numpy(),
                                      np.asarray(getattr(states2_j.peds, f)),
                                      err_msg=f)
