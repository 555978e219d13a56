"""The port's trusted evaluator (``img_env_tpu_torch.eval.batched_eval``)
against the JAX package's, free running, and against the port's own
sequential facade; the recorder, metrics, bank and state snapshots.

The evaluators run ``tests/test_eval_parity.py``'s config cut to 3 m views
at 0.05 m (4 episodes, ``time_max`` 10), without peds and with its 2 SFM
peds, under an exact P-controller (multiplies and clips: XLA's atan2 and
torch's differ by an ulp, F17).  The JAX bank's layouts, drawn under vmap
as the JAX batch reset draws them, are injected through a ``ScenarioBank``
of samples.  Nothing is teacher-forced: the port's robots follow the JAX
robots bit for bit, so the labels and the recorded poses and commands are
equal; the SFM crowd drifts from the JAX crowd from its first step (F15),
which moves the mean ped clearance by under a millimetre here.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.env.nav_env import NavEnv as JaxNavEnv
from img_env_tpu.eval import batched_eval as jeval
from img_env_tpu.eval.recorder import EpisodeRecord as JaxEpisodeRecord
from img_env_tpu.eval.recorder import EpisodeRecorder as JaxEpisodeRecorder
from img_env_tpu.eval.recorder import ScenarioBank as JaxScenarioBank
from img_env_tpu.utils import metrics as jmetrics
from img_env_tpu.utils import trajectory as jtrajectory
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.constants import DONE_TIMEOUT
from img_env_tpu_torch.env.gymapi import make_env
from img_env_tpu_torch.env.nav_env import NavEnv
from img_env_tpu_torch.eval import batched_eval
from img_env_tpu_torch.eval.recorder import (EpisodeRecord, EpisodeRecorder,
                                             ScenarioBank, load_state,
                                             save_state)
from img_env_tpu_torch.utils import metrics, trajectory
from tests.test_eval_parity import _cfg_dict
from tests.test_torch_multiscene import jax_samples

EPISODES = 4
TIME_MAX = 10


def cfg_dict(peds=True):
    d = _cfg_dict()
    d.update(view_map={"resolution": 0.05, "width": 3.0, "height": 3.0},
             time_max=TIME_MAX)
    if not peds:
        d["ped_sim"] = {"total": 0, "type": ""}
    return d


def p_control_t(generator, obs):
    vec = obs.vector_states
    return torch.stack([torch.clamp(0.8 * vec[..., 0], 0.0, 0.6),
                        torch.clamp(2.0 * vec[..., 1], -0.9, 0.9)], -1)


def p_control_j(key, obs):
    vec = obs.vector_states
    return jnp.stack([jnp.clip(0.8 * vec[..., 0], 0.0, 0.6),
                      jnp.clip(2.0 * vec[..., 1], -0.9, 0.9)], -1)


@functools.lru_cache(maxsize=None)
def _banks(peds):
    """(JAX bank of keys, the port's bank of the same episodes' layouts)."""
    jbank = JaxScenarioBank.generate(3, EPISODES)
    with jax.enable_x64(False):
        core = JaxNavEnv(JaxEnvConfig.from_dict(cfg_dict(peds)), jit=False)
    samples = jax_samples(types.SimpleNamespace(core=core),
                          jnp.asarray(jbank.keys))
    return jbank, ScenarioBank(samples=samples)


@functools.lru_cache(maxsize=None)
def _jax_eval(peds):
    with jax.enable_x64(False):
        return jeval.evaluate_batched(
            JaxEnvConfig.from_dict(cfg_dict(peds)), p_control_j, EPISODES,
            bank=_banks(peds)[0], record=True)


@pytest.mark.parametrize("peds", [False, True], ids=["no-peds", "sfm"])
def test_evaluator_matches_jax_free_running(peds):
    """dones_info, the summary and the recorded poses, goals and commands
    of every episode."""
    summary_j, dones_j, rec_j = _jax_eval(peds)
    summary_t, dones_t, rec_t = batched_eval.evaluate_batched(
        EnvConfig.from_dict(cfg_dict(peds)), p_control_t, EPISODES,
        bank=_banks(peds)[1], record=True, device="cpu")
    np.testing.assert_array_equal(dones_t, dones_j)
    assert set(summary_t) == set(summary_j)
    assert ("ped_min_dist_mean" in summary_t) == peds
    for k, v in summary_j.items():
        if k == "ped_min_dist_mean":
            # F15: from rest, the SFM's angular force takes the sign of a
            # rounding-noise angle; here the peds' first velocities differ
            # by up to 0.033 m/s and their positions by up to 0.023 m by
            # step 10 (measured), so the clearances by as much
            assert summary_t[k] == pytest.approx(v, rel=0, abs=0.025), k
        elif k != "wall_s":
            assert summary_t[k] == v, k
    assert len(rec_t.episodes) == len(rec_j.episodes) == EPISODES
    for et, ej in zip(rec_t.episodes, rec_j.episodes):
        np.testing.assert_array_equal(et.goals, ej.goals)
        np.testing.assert_array_equal(et.dones_info, ej.dones_info)
        for k in ("robot_poses", "robot_vws"):
            np.testing.assert_array_equal(et.arrays()[k], ej.arrays()[k],
                                          err_msg=k)
    assert rec_t.summary() == rec_j.summary()


def test_sequential_facade_equals_batched_evaluator(tmp_path):
    """The port's facade, one bank episode at a time with the full wrapper
    stack (``cfg_type: bag``, ``reset(carry=False)``), labels every robot
    as the port's batched evaluator does."""
    path = str(tmp_path / "bank.npz")
    ScenarioBank.generate(3, EPISODES).save(path)
    d = cfg_dict()
    d.update(cfg_type="bag", init_pose_bag_name=path,
             init_pose_bag_episodes=EPISODES)
    env = make_env(d, seed=0, device="cpu")
    n = env.robot_total
    seq = np.zeros((EPISODES, n), np.int64)
    for ep in range(EPISODES):
        env.reset(carry=False)
        info = None
        for _ in range(TIME_MAX + 1):
            actions = p_control_t(None, env.last_raw_obs).numpy()
            _, _, _, info = env.step(actions)
            if bool(info["all_down"]):
                break
        di = info["dones_info"].reshape(-1)
        seq[ep] = np.where(di == 0, DONE_TIMEOUT, di)
    summary, bat = batched_eval.evaluate_batched(
        EnvConfig.from_dict(cfg_dict()), p_control_t, EPISODES,
        bank=ScenarioBank.load(path), device="cpu")
    np.testing.assert_array_equal(bat, seq)
    assert set(np.unique(bat)) <= {1, 2, 3, 5, 10}
    assert summary["episodes"] == EPISODES


def test_evaluator_mpc_path_matches_jax(monkeypatch):
    """``mpc=``: one scene-batched act over all S*N robots, with the JAX
    evaluator's MPPI noise injected step by step; the labels equal and the
    recorded commands within MPPI's float32 spread (F12: 5e-4 a step)."""
    from img_env_tpu.mpc import MppiConfig as JaxMppiConfig
    from img_env_tpu_torch.mpc.controller import MpcController
    from img_env_tpu_torch.mpc.mppi import MppiConfig

    k, h, steps, n = 32, 6, 3, 2
    with jax.enable_x64(False):
        summary_j, dones_j, rec_j = jeval.evaluate_batched(
            JaxEnvConfig.from_dict(cfg_dict(False)), None, EPISODES,
            max_steps=steps, bank=_banks(False)[0],
            mpc=JaxMppiConfig(horizon=h, samples=k), record=True)
        noises, key = [], jax.random.PRNGKey(1)
        draw = jax.vmap(lambda kk: jax.random.normal(kk, (k, h, 2)))
        for _ in range(steps):
            key, sub = jax.random.split(key)
            noises.append(np.concatenate([
                np.array(draw(jax.random.split(kk, n)))
                for kk in jax.random.split(sub, EPISODES)]))
    queue = [torch.as_tensor(x) for x in noises]
    monkeypatch.setattr(MpcController, "draw_noise",
                        lambda self, dtype=None, scenes=1: queue.pop(0))
    summary_t, dones_t, rec_t = batched_eval.evaluate_batched(
        EnvConfig.from_dict(cfg_dict(False)), None, EPISODES,
        max_steps=steps, bank=_banks(False)[1],
        mpc=MppiConfig(horizon=h, samples=k), record=True, device="cpu")
    assert not queue
    np.testing.assert_array_equal(dones_t, dones_j)
    for et, ej in zip(rec_t.episodes, rec_j.episodes):
        np.testing.assert_allclose(et.arrays()["robot_vws"],
                                   ej.arrays()["robot_vws"], rtol=0,
                                   atol=5e-4)
        np.testing.assert_allclose(et.arrays()["robot_poses"],
                                   ej.arrays()["robot_poses"], rtol=0,
                                   atol=5e-4 * steps)


def test_force_beep_off_and_default_bank(monkeypatch):
    """``force_beep_off`` zeroes the beep channel of a 3-wide action, and
    without a bank the evaluator draws ``ScenarioBank.generate(seed)``."""
    from img_env_tpu_torch.parallel import batched_env

    seen = []

    class Spy(batched_env.BatchedNavEnv):
        def step(self, states, actions, beep_u=None):
            seen.append(actions.clone())
            return super().step(states, actions, beep_u)

    def policy(generator, obs):
        return torch.full(obs.vector_states.shape[:2] + (3,), 0.1)

    monkeypatch.setattr(batched_env, "BatchedNavEnv", Spy)
    cfg = EnvConfig.from_dict(cfg_dict(False))
    a = batched_eval.evaluate_batched(cfg, policy, 2, max_steps=2,
                                      force_beep_off=True, device="cpu")
    b = batched_eval.evaluate_batched(cfg, policy, 2, max_steps=2,
                                      bank=ScenarioBank.generate(0, 2),
                                      device="cpu")
    assert len(seen) == 4
    assert all(float(x[..., 2].abs().max()) == 0.0 for x in seen[:2])
    assert all(bool((x[..., 2] == np.float32(0.1)).all()) for x in seen[2:])
    np.testing.assert_array_equal(a[1], b[1])


# ---------------------------------------------------------------------
# recorder, metrics, trajectory statistics: the same records in both
# ---------------------------------------------------------------------


def _records(rng, episodes=5, n=3, m=2):
    recs = []
    for e in range(episodes):
        t = int(rng.integers(1, 9))
        recs.append(dict(
            robot_poses=rng.normal(0, 3, (t, n, 3)).astype(np.float32),
            robot_vws=rng.uniform(-0.9, 0.9, (t, n, 2)).astype(np.float32),
            ped_poses=rng.normal(0, 3, (t, m, 2)).astype(np.float32),
            rewards=rng.normal(0, 5, (t, n)).astype(np.float32),
            goals=rng.normal(0, 3, (n, 2)).astype(np.float32),
            dones_info=rng.choice([1, 2, 3, 5, 10], n)))
    return recs


def test_recorder_summary_and_npz_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    rt, rj = EpisodeRecorder(dt=0.25), JaxEpisodeRecorder(dt=0.25)
    for r in _records(rng):
        for rec, cls in ((rt, EpisodeRecord), (rj, JaxEpisodeRecord)):
            e = cls(goals=r["goals"], dones_info=r["dones_info"])
            for k in ("robot_poses", "robot_vws", "ped_poses", "rewards"):
                setattr(e, k, list(r[k]))
            rec.episodes.append(e)
    rt.episodes.append(EpisodeRecord())          # empty: skipped by both
    rj.episodes.append(JaxEpisodeRecord())
    assert rt.summary() == rj.summary()
    assert rt.summary(v_max=0.5) == rj.summary(v_max=0.5)
    path = str(tmp_path / "rec.npz")
    rt.save(path)
    back = EpisodeRecorder.load(path)
    assert back.dt == 0.25 and len(back.episodes) == len(rt.episodes)
    assert back.summary() == rt.summary()
    assert JaxEpisodeRecorder.load(path).summary() == rj.summary()


def test_recorder_add_step_from_a_state():
    env = NavEnv(EnvConfig.from_dict(cfg_dict()), "cpu")
    state, _ = env.reset()
    rec = EpisodeRecorder(dt=0.4)
    rec.add_step(state, reward=torch.zeros(2))
    rec.add_step(state, speeds=torch.ones(2, 2))
    rec.end_episode(torch.tensor([5, 10]), result="done")
    e = rec.episodes[0]
    np.testing.assert_array_equal(e.goals, state.robots.goal.numpy())
    assert e.arrays()["robot_poses"].shape == (2, 2, 3)
    assert e.arrays()["ped_poses"].shape == (2, 2, 2)
    np.testing.assert_array_equal(e.robot_vws[1], np.ones((2, 2)))
    assert e.result == "done" and list(e.dones_info) == [5, 10]


def test_episode_metrics_and_trajectory_stats():
    """EpisodeMetrics over a stream of steps and episode ends (short
    episodes skipped), TrajectoryStats on the same v/w series, and
    batched_dones_summary, each equal to the JAX package's."""
    rng = np.random.default_rng(1)
    cfg_t = EnvConfig.from_dict(cfg_dict())
    cfg_j = JaxEnvConfig.from_dict(cfg_dict())
    mt, mj = metrics.EpisodeMetrics(cfg_t), jmetrics.EpisodeMetrics(cfg_j)
    for e in range(8):
        steps = int(rng.integers(1, 12))
        for _ in range(steps):
            sp = rng.uniform(-0.9, 0.9, (2, 2)).astype(np.float32)
            sp[0, 1] = 0.0 if rng.uniform() < 0.2 else sp[0, 1]
            mt.add_step({"speeds": sp})
            mj.add_step({"speeds": sp})
        di = np.array([rng.choice([1, 2, 3, 5, 10]), 0])
        mt.end_episode(di)
        mj.end_episode(di)
    assert mt.summary() == mj.summary()
    w = rng.uniform(-1, 1, 20)
    w[[3, 4, 9]] = 0.0
    v = rng.uniform(0, 0.6, 20)
    tt, tj = trajectory.TrajectoryStats(0.25), jtrajectory.TrajectoryStats(0.25)
    for a, b in zip(v, w):
        tt.add_vw(a, b)
        tj.add_vw(a, b)
    assert tt.metric_dict() == tj.metric_dict()
    assert tt.w_variance() == tj.w_variance()
    d = rng.choice([1, 2, 3, 5, 10], (6, 3))
    assert metrics.batched_dones_summary(d) == jmetrics.batched_dones_summary(d)


# ---------------------------------------------------------------------
# bank and state round trips
# ---------------------------------------------------------------------


def test_scenario_bank_roundtrips(tmp_path):
    """Seeds and explicit samples survive save/load; a JAX bank file loads
    as one seed per key; an episode is a pure function of its seed,
    whatever the order it is drawn in."""
    spec = NavEnv(EnvConfig.from_dict(cfg_dict()), "cpu").statics.sampler
    bank = ScenarioBank.generate(7, 3)
    assert bank.seeds.dtype == np.int64 and len(bank) == 3
    path = str(tmp_path / "seeds.npz")
    bank.save(path)
    back = ScenarioBank.load(path)
    np.testing.assert_array_equal(back.seeds, bank.seeds)
    fwd = [bank.sample(e, spec) for e in range(3)]
    rev = [back.sample(e, spec) for e in (2, 1, 0)][::-1]
    for a, b in zip(fwd, rev):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert torch.equal(bank.sample(4, spec).init_poses, fwd[1].init_poses)

    sbank = ScenarioBank(samples=fwd)
    spath = str(tmp_path / "samples.npz")
    sbank.save(spath)
    sback = ScenarioBank.load(spath)
    for e in range(3):
        for x, y in zip(sback.sample(e, spec), fwd[e]):
            assert torch.equal(x, y)

    jpath = str(tmp_path / "jax.npz")
    JaxScenarioBank.generate(3, 4).save(jpath)
    keys = np.load(jpath)["keys"].astype(np.uint64)
    jb = ScenarioBank.load(jpath)
    want = ((keys[:, 0] << np.uint64(32)) | keys[:, 1]) & np.uint64(2**63 - 1)
    np.testing.assert_array_equal(jb.seeds, want.astype(np.int64))


def test_save_and_load_state(tmp_path):
    """A WorldState snapshot restores every tensor, dtype and shape; a
    snapshot of another shape is refused."""
    env = NavEnv(EnvConfig.from_dict(cfg_dict()), "cpu")
    state, _ = env.reset()
    path = str(tmp_path / "state.npz")
    save_state(path, state)
    back = load_state(path, state)
    assert type(back) is type(state)
    flat = lambda s: jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x: x.numpy(), s))
    for a, b in zip(flat(back), flat(state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    other = NavEnv(EnvConfig.from_dict(cfg_dict(False)), "cpu").reset()[0]
    with pytest.raises(ValueError):
        load_state(path, other)
