"""The port's wrapper functions (``img_env_tpu_torch.env.wrappers`` and
``rewards.paper_reward``) against the JAX package's, bit for bit, on seeded
numpy inputs.

The JAX facade runs the stack op by op, outside any jit
(img_env_tpu/env/gymapi.py:221-227), so the JAX side here is called the
same way, under ``jax.enable_x64(False)`` (the test session turns x64 on).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_env  # noqa: F401  (one torch thread per worker)
from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.core.state import Observation as JaxObservation
from img_env_tpu.env import rewards as jrewards
from img_env_tpu.env import wrappers as jw
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.constants import ARRIVE_DIST
from img_env_tpu_torch.core.state import Observation
from img_env_tpu_torch.env import rewards as trewards
from img_env_tpu_torch.env import wrappers as tw

N = 12
ALL_WRAPPERS = [
    "VelActionWrapper", "TimeLimitWrapper", "SensorsPaperRewardWrapper",
    "InfoLogWrapper", "MultiRobotCleanWrapper", "StatePedVectorWrapper",
    "StateBatchWrapper", "NeverStopWrapper",
]


def cfg_dict(peds=2, batches=(1, 3, 1), discrete=False):
    """A config whose stack, sizes and action space the wrappers read."""
    ib, sb, lb = batches
    d = {
        "time_max": 5, "state_dim": 5, "max_ped": 3, "range_total": 16,
        "image_batch": ib, "state_batch": sb, "laser_batch": lb,
        "ped_safety_space": 0.4, "wrapper": ALL_WRAPPERS,
        "continuous_actions": [[0, 0.6], [-0.9, 0.9], [-0.6, 0.6]],
        "robot": {"total": N},
        "ped_sim": ({"total": peds, "type": "pedscene"} if peds
                    else {"total": 0, "type": ""}),
    }
    if discrete:
        d["discrete_action"] = True
        d["discrete_actions"] = [[0.0, 0.0], [0.3, 0.5], [0.6, -0.9, 1.0]]
    return d


def both_cfgs(**kw):
    d = cfg_dict(**kw)
    return JaxEnvConfig.from_dict(d), EnvConfig.from_dict(d)


def _eq(got, want, msg=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=msg)


def obs_arrays(rng, cfg, n=N):
    """A seeded observation: codes 0-3 and arrivals, same-step arrive and
    collision rows, ped distances around the 1 m and safety thresholds
    (and inf, no ped), goals near the arrival radius."""
    coll = rng.integers(0, 4, n).astype(np.int32)
    coll[rng.uniform(size=n) < 0.5] = 0
    arr = (rng.uniform(size=n) < 0.3).astype(np.int32)
    arr[0], coll[0] = 1, 2
    vec = rng.normal(0, 1.5, (n, cfg.state_dim)).astype(np.float32)
    vec[1, :2] = (ARRIVE_DIST, 0.0)
    vec[2, :2] = (0.1, -0.2)
    pmd = rng.uniform(0, 1.5, n).astype(np.float32)
    pmd[3] = np.float32(cfg.ped_safety_space)
    pmd[4] = np.inf
    pmd[5] = 1.0
    count = rng.integers(0, cfg.max_ped + 2, n).astype(np.float32)
    count[:3] = (0, cfg.max_ped, cfg.max_ped + 1)
    pv = rng.normal(0, 3, (n, 1 + cfg.ped_vec_dim * cfg.max_ped))
    pv[:, 0] = count
    h, w = cfg.image_size
    return dict(
        vector_states=vec,
        sensor_maps=rng.uniform(0, 1, (n, h, w)).astype(np.float32),
        is_collisions=coll, is_arrives=arr,
        lasers=rng.uniform(0, 1, (n, cfg.range_total)).astype(np.float32),
        ped_vector_states=pv.astype(np.float32),
        ped_maps=rng.normal(0, 1, (n, 3, h, w)).astype(np.float32),
        step_ds=rng.normal(0, 0.2, n).astype(np.float32),
        ped_min_dists=pmd)


def both_obs(arrays):
    return (JaxObservation(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            Observation(**{k: torch.as_tensor(v) for k, v in arrays.items()}))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paper_reward(seed):
    """Collided (the -500 overwrites the proximity term), reached by
    distance or by the latched flag, proximity and moving rows; ties at
    ``ped_safety_space`` and at ``ARRIVE_DIST``."""
    jcfg, cfg = both_cfgs()
    rng = np.random.default_rng(seed)
    a = obs_arrays(rng, cfg)
    # rows 1-3 and 6-9 uncollided: 1 at the arrival radius, 2 inside it,
    # 3 and 6 at the safety distance, 8 arrived by the latched flag only
    a["is_collisions"][[1, 2, 3, 6, 7, 8, 9]] = 0
    a["is_arrives"][[1, 2, 3, 6, 7, 9]] = 0
    a["is_arrives"][8] = 1
    a["ped_min_dists"][6] = np.float32(0.4)
    a["vector_states"][7, :2] = (np.float32(0.3) * np.float32(0.6),
                                 np.float32(0.3) * np.float32(0.8))
    args = [a[k] for k in ("vector_states", "is_collisions", "is_arrives",
                           "step_ds", "ped_min_dists")]
    with jax.enable_x64(False):
        want = jrewards.paper_reward(*map(jnp.asarray, args), 0.4)
        want_w = jw.paper_reward_wrapper(jcfg, both_obs(a)[0], None)
    got = trewards.paper_reward(*map(torch.as_tensor, args), 0.4)
    _eq(got, want, "paper_reward")
    _eq(tw.paper_reward_wrapper(cfg, both_obs(a)[1], None), want_w)
    vals = set(got.numpy().tolist())
    assert -500.0 in vals and 500.0 in vals       # collided and reached rows


@pytest.mark.parametrize("discrete", [False, True])
def test_vel_action_map(discrete):
    jcfg, cfg = both_cfgs(discrete=discrete)
    rng = np.random.default_rng(3)
    if discrete:
        acts = [rng.integers(0, 3, N)]
    else:
        acts = [rng.uniform(-1.5, 1.5, (N, k)).astype(np.float32)
                for k in (2, 3)]
    for a in acts:
        with jax.enable_x64(False):
            cj, sj = jw.vel_action_map(jcfg, jnp.asarray(a))
        ct, st = tw.vel_action_map(cfg, torch.as_tensor(a))
        _eq(ct, cj, "cmds")
        _eq(st, sj, "speeds")


def test_vel_action_map_rejects_pairs_for_discrete():
    """A discrete config takes [N] indices: (v, w) pairs [N, 2] raise."""
    jcfg, cfg = both_cfgs(discrete=True)
    pairs = np.zeros((N, 2), np.float32)
    with pytest.raises(ValueError):
        jw.vel_action_map(jcfg, jnp.asarray(pairs))
    with pytest.raises(ValueError):
        tw.vel_action_map(cfg, torch.as_tensor(pairs))


def test_time_limit_info_log_and_clean():
    """The time limit, InfoLog's label priority (arrive beats a same-step
    collision) and the clean masks, with and without pedestrians."""
    for peds in (2, 0):
        jcfg, cfg = both_cfgs(peds=peds)
        rng = np.random.default_rng(4 + peds)
        a = obs_arrays(rng, cfg)
        oj, ot = both_obs(a)
        elapsed = rng.integers(3, 8, N).astype(np.int32)
        clean = rng.uniform(size=N) < 0.7
        done = rng.integers(0, 2, N).astype(np.int32)
        di = rng.choice([0, 1, 5], N).astype(np.int32)
        reward = rng.normal(0, 10, N).astype(np.float32)
        speeds = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
        with jax.enable_x64(False):
            wsj = jw.init_wrapper_state(jcfg)._replace(
                elapsed=jnp.asarray(elapsed), is_clean=jnp.asarray(clean))
            wsj, dj, dij = jw.time_limit_wrapper(jcfg, wsj, jnp.asarray(done),
                                                 jnp.asarray(di))
            infoj = jw.info_log_wrapper(jcfg, oj, dj, {"dones_info": dij})
            wsj, rj, spj, infoj = jw.multi_robot_clean_wrapper(
                wsj, jnp.asarray(reward), jnp.asarray(speeds), dj, infoj)
        wst = tw.init_wrapper_state(cfg, device="cpu")._replace(
            elapsed=torch.as_tensor(elapsed), is_clean=torch.as_tensor(clean))
        wst, dt, dit = tw.time_limit_wrapper(cfg, wst, torch.as_tensor(done),
                                             torch.as_tensor(di))
        infot = tw.info_log_wrapper(cfg, ot, dt, {"dones_info": dit})
        wst, rt, spt, infot = tw.multi_robot_clean_wrapper(
            wst, torch.as_tensor(reward), torch.as_tensor(speeds), dt, infot)
        assert set(infot) == set(infoj)
        assert ("bool_get_close_to_human" in infot) == (peds > 0)
        for k in infoj:
            _eq(infot[k], infoj[k], k)
        for f in ("elapsed", "is_clean"):
            _eq(getattr(wst, f), getattr(wsj, f), f)
        _eq(dt, dj, "done")
        _eq(rt, rj, "reward")
        _eq(spt, spj, "speeds")
        assert int(infot["dones_info"][0]) == 5      # arrive over code 2


@pytest.mark.parametrize("seed", [0, 1])
def test_ped_vector_normalize(seed):
    """Counts 0, partial, max_ped and above it."""
    jcfg, cfg = both_cfgs()
    a = obs_arrays(np.random.default_rng(10 + seed), cfg)
    oj, ot = both_obs(a)
    with jax.enable_x64(False):
        want = jw.ped_vector_normalize(oj, jcfg).ped_vector_states
    got = tw.ped_vector_normalize(ot, cfg).ped_vector_states
    _eq(got, want)
    np.testing.assert_array_equal(got[0].numpy(), a["ped_vector_states"][0])


@pytest.mark.parametrize("batches", [(0, 0, -1), (1, 1, 0), (3, 3, 3)],
                         ids=["batch0", "batch1", "batch3"])
def test_state_batch_push_and_clear(batches):
    jcfg, cfg = both_cfgs(batches=batches)
    rng = np.random.default_rng(20)
    with jax.enable_x64(False):
        wsj = jw.init_wrapper_state(jcfg)
    wst = tw.init_wrapper_state(cfg, device="cpu")
    for f in tw.WrapperState._fields:
        _eq(getattr(wst, f), getattr(wsj, f), f)
    for _ in range(4):
        oj, ot = both_obs(obs_arrays(rng, cfg))
        with jax.enable_x64(False):
            wsj, *outj = jw.state_batch_push(jcfg, wsj, oj)
        wst, *outt = tw.state_batch_push(cfg, wst, ot)
        for name, g, w in zip(("images", "vectors", "lasers"), outt, outj):
            _eq(g, w, name)
    with jax.enable_x64(False):
        wsj = jw.state_batch_clear(wsj)
    wst = tw.state_batch_clear(wst)
    for f in tw.WrapperState._fields:
        _eq(getattr(wst, f), getattr(wsj, f), f)


def test_wrapper_stack_reset_and_steps():
    """``WrapperStack.on_reset`` and three ``on_step``s with every wrapper
    on: the stacked observation, rewards, dones, every info key and the
    wrapper state."""
    jcfg, cfg = both_cfgs(batches=(1, 3, 1))
    rng = np.random.default_rng(30)
    js, ts = jw.WrapperStack(jcfg), tw.WrapperStack(cfg, device="cpu")
    oj, ot = both_obs(obs_arrays(rng, cfg))
    with jax.enable_x64(False):
        wsj, sj = js.on_reset(js.init_state(), oj)
    wst, st = ts.on_reset(ts.init_state(), ot)
    for t in range(3):
        for f in ("sensor_maps", "vector_states", "lasers"):
            _eq(getattr(st, f), getattr(sj, f), f)
        _eq(st.raw.ped_vector_states, sj.raw.ped_vector_states)
        a = obs_arrays(rng, cfg)
        oj, ot = both_obs(a)
        coll, arr = a["is_collisions"], a["is_arrives"]
        reward = (arr - coll).astype(np.float32)
        done = np.clip(np.clip(coll, -1, 1) + arr, 0, 1).astype(np.int32)
        speeds = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
        with jax.enable_x64(False):
            info = {"dones_info": jnp.zeros(N, jnp.int32),
                    "speeds": jnp.asarray(speeds)}
            wsj, sj, rj, dj, ij = js.on_step(wsj, oj, jnp.asarray(reward),
                                             jnp.asarray(done), info)
        info = {"dones_info": torch.zeros(N, dtype=torch.int32),
                "speeds": torch.as_tensor(speeds)}
        wst, st, rt, dt, it = ts.on_step(wst, ot, torch.as_tensor(reward),
                                         torch.as_tensor(done), info)
        _eq(rt, rj, f"reward step {t}")
        _eq(dt, dj, f"done step {t}")
        assert set(it) == set(ij)
        for k in ij:
            _eq(it[k], ij[k], f"{k} step {t}")
        for f in tw.WrapperState._fields:
            _eq(getattr(wst, f), getattr(wsj, f), f)
