"""The port's gym facade (``img_env_tpu_torch.env.gymapi``: ``make_env``,
``ImgNavEnv`` with its wrapper stack) against the JAX package's, on
``tests/test_eval_parity.py``'s config cut to 3 m views at 0.05 m and 32
beams (2 robots, 2 circle obstacles, 2 SFM peds in ``room_10.png``).

Both facades run float32 (the JAX side under ``jax.enable_x64(False)``).
The JAX layouts are injected (torch cannot reproduce threefry draws), and
the crowd is teacher-forced: each port step runs the port's own robot
dynamics and observation on the peds of the JAX env's next state
(``Teacher`` below), as ``tests/test_torch_multiscene.py`` does; the
crowd floats themselves are held to the JAX crowd there (F15).  Every
filtered observation, reward, done and ``info`` key is then equal (the
vector states' relative yaw within an ulp, F17), through a NeverStop
auto-reset, in the flat two-scene facade, under ``cfg_type: bag`` and on
a replayed ETH world.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.env import gymapi as jgymapi
from img_env_tpu.env.sampler import sample_scenario_retry
from img_env_tpu.env.wrappers import vel_action_map as jax_vel_action_map
from img_env_tpu.eval.recorder import ScenarioBank as JaxScenarioBank
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.core.convert import world_state_from_numpy
from img_env_tpu_torch.env import gymapi
from img_env_tpu_torch.env.nav_env import NavEnv
from img_env_tpu_torch.env.sampler import ScenarioSample
from img_env_tpu_torch.eval.recorder import ScenarioBank
from img_env_tpu_torch.parallel import BatchedNavEnv
from tests.test_eval_parity import _cfg_dict
from tests.test_torch_env import _assert_vector_states, _np
from tests.test_torch_multiscene import jax_samples

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "eth_world_fixture.csv")
WRAPPERS = ["VelActionWrapper", "TimeLimitWrapper",
            "SensorsPaperRewardWrapper", "InfoLogWrapper",
            "MultiRobotCleanWrapper", "StateBatchWrapper",
            "ObsLaserStateTmp", "NeverStopWrapper"]
EPISODES = 3
STEPS = 7          # time_max 4: every robot is down by step 5, auto-reset


def cfg_dict(**over):
    d = _cfg_dict()
    d.update(view_map={"resolution": 0.05, "width": 3.0, "height": 3.0},
             range_total=32, time_max=4, wrapper=list(WRAPPERS))
    d.update(over)
    return d


def p_control(vec):
    """An exact P-controller (multiplies and clips; ROADMAP F17: no
    atan2)."""
    vec = np.asarray(vec, np.float32)
    v = np.clip(np.float32(0.8) * vec[:, 0], 0.0, 0.6)
    w = np.clip(np.float32(2.0) * vec[:, 1], -0.9, 0.9)
    return np.stack([v, w], -1).astype(np.float32)


class Teacher:
    """The port's NavEnv or BatchedNavEnv with the crowd teacher-forced:
    ``step`` runs the port's robot dynamics, puts in the peds of the JAX
    env's next state (``self.next``), and observes; ``reset`` takes the
    queued JAX layouts when the facade asks for its own draw."""

    def __init__(self, env):
        self.env = env
        self.next = None
        self.queue = []

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, samples=None, carry=None, **kw):
        if samples is None or isinstance(samples, int):
            samples = self.queue.pop(0)
        return self.env.reset(samples, carry, **kw)

    def step(self, state, actions):
        nxt = world_state_from_numpy(_np(self.next))
        crowd = dict(peds=nxt.peds, crowd_aux=nxt.crowd_aux)
        if isinstance(self.env, BatchedNavEnv):
            core = self.env.core
            adv, alive, beeps = core.advance_scenes(state, actions)
            st, obs = core.observe_scenes(adv._replace(**crowd))
        else:
            adv, alive, beeps = self.env.advance_fn(state, actions)
            st, obs = self.env._observe(adv._replace(**crowd))
        return NavEnv.finish_step(st, obs, alive, beeps)


def assert_filtered_equal(got, want, state_dim=3):
    """A filtered observation ([lasers or maps, vectors, ped maps]) or a
    StackedObs."""
    if isinstance(got, list):
        assert len(got) == len(want) == 3
        pairs = zip(("first", "vector_states", "ped_maps"), got, want)
    else:
        pairs = [(f, getattr(got, f).numpy(), getattr(want, f))
                 for f in ("sensor_maps", "vector_states", "lasers")]
        pairs += [("raw." + f, getattr(got.raw, f).numpy(),
                   getattr(want.raw, f))
                  for f in ("ped_maps", "ped_vector_states", "is_collisions",
                            "ped_min_dists")]
    for name, g, w in pairs:
        w = np.asarray(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if name == "vector_states":
            _assert_vector_states(g.reshape(-1, state_dim),
                                  w.reshape(-1, state_dim))
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)


def assert_step_equal(got, want):
    (o_t, r_t, d_t, i_t), (o_j, r_j, d_j, i_j) = got, want
    assert_filtered_equal(o_t, o_j)
    np.testing.assert_array_equal(r_t, np.asarray(r_j))
    np.testing.assert_array_equal(d_t, np.asarray(d_j))
    assert set(i_t) == set(i_j)
    for k in i_j:
        np.testing.assert_array_equal(i_t[k], np.asarray(i_j[k]), err_msg=k)


class Pair:
    """A JAX facade and the port's on the CPU, stepped together."""

    def __init__(self, d, record=False):
        with jax.enable_x64(False):
            self.j = jgymapi.make_env(d, seed=0, record=record)
        self.t = gymapi.make_env(d, seed=0, device="cpu", record=record)
        self.jcfg = self.j.cfg
        if self.t.scenes > 1:
            self.t.core._env = self.teacher = Teacher(self.t.core._env)
            self._sampler = lambda k: jax_samples(
                self.j.core._env, jax.random.split(k, self.t.scenes))
        else:
            self.t.core = self.teacher = Teacher(self.t.core)
            spec = self.j.core.statics.sampler
            with jax.enable_x64(False):
                program = jax.jit(lambda k: sample_scenario_retry(
                    jax.random.split(k)[0], spec))
            self._sampler = lambda k: self._one(program, k)

    @staticmethod
    def _one(program, key):
        with jax.enable_x64(False):
            sc = program(key)
        return ScenarioSample(*(torch.as_tensor(np.array(x)) for x in sc))

    def sample(self, key):
        return self._sampler(key)

    def reset(self, key):
        with jax.enable_x64(False):
            want = self.j.reset(key=key, carry=False)
        got = self.t.reset(carry=False, sample=self.sample(key))
        assert_filtered_equal(got, want)

    def step(self):
        actions = p_control(np.asarray(self.j.last_raw_obs.vector_states))
        with jax.enable_x64(False):
            cmds = jax_vel_action_map(self.jcfg, jnp.asarray(actions))[0]
            self.teacher.next = self.j.core.step(self.j._state, cmds)[0]
            # the layout JAX's auto-reset would draw (ImgNavEnv._next_key)
            _, k_next = jax.random.split(self.j._key)
            self.teacher.queue = [self.sample(k_next)]
            want = self.j.step(actions)
        got = self.t.step(actions)
        assert_step_equal(got, want)
        return got


@functools.lru_cache(maxsize=None)
def _pair(scenes):
    return Pair(cfg_dict(num_scenes=scenes), record=scenes == 1)


@pytest.mark.parametrize("filt", ["laser", "image", None])
def test_facade_matches_jax(filt):
    """Filtered observations, rewards, dones and every ``info`` key through
    a NeverStop auto-reset (all robots time out after ``time_max``)."""
    p = _pair(1)
    p.j._obs_filter = p.t._obs_filter = filt
    p.reset(jax.random.PRNGKey(11))
    downs = 0
    for _ in range(STEPS):
        _, _, _, info = p.step()
        downs += bool(info["all_down"])
    assert downs >= 1
    np.testing.assert_array_equal(p.t.state.robots.pose.numpy(),
                                  np.asarray(p.j._state.robots.pose))
    assert p.t.metrics.summary() == p.j.metrics.summary()


def test_pick_filter():
    for w, want in ((["ObsLaserStateTmp"], "laser"), (["ObsStateTmp"], "image"),
                    (["TimeLimitWrapper"], None)):
        cfg = EnvConfig.from_dict(cfg_dict(wrapper=w))
        assert gymapi.ImgNavEnv._pick_filter(cfg) == want
        assert jgymapi.ImgNavEnv._pick_filter(
            JaxEnvConfig.from_dict(cfg_dict(wrapper=w))) == want


def test_recorder_matches_jax():
    """The facade's recorder (record=True): poses, speeds and rewards of
    every recorded episode equal."""
    p = _pair(1)
    p.j.recorder.episodes.clear()
    p.t.recorder.episodes.clear()
    p.reset(jax.random.PRNGKey(12))
    for _ in range(STEPS):
        p.step()
    assert len(p.t.recorder.episodes) == len(p.j.recorder.episodes) >= 2
    for et, ej in zip(p.t.recorder.episodes, p.j.recorder.episodes):
        for k, v in ej.arrays().items():
            np.testing.assert_array_equal(et.arrays()[k], v, err_msg=k)


def test_flat_two_scene_facade_matches_jax():
    """``num_scenes = 2``: two scenes flattened to [S*N] robots."""
    p = _pair(2)
    p.reset(jax.random.PRNGKey(13))
    assert p.t.robot_total == 4
    for _ in range(STEPS):
        _, r, _, info = p.step()
        assert r.shape == (4,) and info["dones_info"].shape == (4,)


def test_bag_replay_matches_jax(tmp_path):
    """``cfg_type: bag``: the JAX facade replays a bank of keys; the port's
    replays a bank holding the same episodes' layouts (saved and loaded);
    the episode sequence and every reset observation are equal, and two
    port facades on one bank file replay the same episodes."""
    p = _pair(1)
    jbank = JaxScenarioBank.generate(3, EPISODES)
    bank = ScenarioBank(samples=[p.sample(jnp.asarray(k)) for k in jbank.keys])
    path = str(tmp_path / "bank.npz")
    bank.save(path)
    d = cfg_dict(cfg_type="bag", init_pose_bag_name=path)
    env_t = gymapi.make_env(d, device="cpu")
    assert len(env_t.scenario_bank) == EPISODES
    p.j._obs_filter = p.t._obs_filter = "laser"
    p.j.scenario_bank, p.j._episode_idx = jbank, 0
    p.t.scenario_bank, p.t._episode_idx = env_t.scenario_bank, 0
    try:
        for _ in range(EPISODES + 1):           # cycles back to episode 0
            with jax.enable_x64(False):
                want = p.j.reset(carry=False)
            assert_filtered_equal(p.t.reset(carry=False), want)
            assert_filtered_equal(env_t.reset(carry=False), want)
            p.step()
    finally:
        p.j.scenario_bank = p.t.scenario_bank = None


def test_seeded_bag_replays_its_episodes(tmp_path):
    """A generated port bank (int64 seeds) saved under ``cfg_type: bag``:
    a second facade on the same file replays the same episodes."""
    path = str(tmp_path / "seeds.npz")
    d = cfg_dict(cfg_type="bag", init_pose_bag_name=path,
                 init_pose_bag_episodes=2)
    a = gymapi.make_env(d, seed=5, device="cpu")
    assert os.path.exists(path) and len(a.scenario_bank) == 2
    b = gymapi.make_env(d, seed=9, device="cpu")
    for _ in range(3):
        oa, ob = a.reset(carry=False), b.reset(carry=False)
        for x, y in zip(oa, ob):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.state.robots.pose.numpy(),
                                  b.state.robots.pose.numpy())


def test_dataset_world_facade_matches_jax():
    """A ``ped_traj_dataset`` world (tests/data/eth_world_fixture.csv, two
    worlds of 3 peds, advancing every reset), the robot on a fixed pose:
    the port's facade replays the JAX facade's worlds."""
    d = {
        "env_type": "robot_nav", "ped_traj_dataset": FIXTURE,
        "swapxy": True, "offset": [5.0, 5.0, 0.0],
        "scale_x": 0.7, "scale_y": 0.7, "fps": 15,
        "ped_dataset_worlds": [[0, 2], [3, 5]],
        "repeated_time_per_env": 1,
        "robot": {"total": 1, "begin_poses_type": ["fix"],
                  "begin_poses": [[1.6, 1.6, 0.0]],
                  "target_poses_type": ["fix"], "target_poses": [[9.2, 1.6]]},
        "ped_sim": {"total": 3, "type": "dataset", "max_speed": [1.0],
                    "shape": ["circle"], "size": [[0.0, 0.0, 0.17]],
                    "begin_poses_type": ["range"],
                    "begin_poses": [[1.0, 9.0, 1.0, 9.0]],
                    "target_poses_type": ["range"],
                    "target_poses": [[1.0, 9.0, 1.0, 9.0]]},
        "global_map": {"map_file": "room_10.png", "resolution": 0.1},
        "view_map": {"resolution": 0.05, "width": 3.0, "height": 3.0},
        "range_total": 32, "max_ped": 3, "wrapper": WRAPPERS[:-2],
    }
    p = Pair(d)
    for ep in range(3):                      # world 0, 1, then 0 again
        with jax.enable_x64(False):
            key = jax.random.PRNGKey(20 + ep)
            want = p.j.reset(key=key)
        got = p.t.reset(sample=p.sample(key))
        assert_filtered_equal(got, want)
        np.testing.assert_allclose(p.t.state.peds.pos.numpy(),
                                   np.asarray(p.j._state.peds.pos), atol=0)
        for _ in range(2):
            p.step()


def test_unported_frontends_raise():
    """The frontends are ported (tests/test_torch_frontends.py): 'real_env'
    gives the wrapped hardware facade, and 'gazebo_env' without a
    transport raises the JAX package's ValueError."""
    env = gymapi.make_env(cfg_dict(env_type="real_env"), device="cpu")
    assert isinstance(env, gymapi.WrappedFrontend)
    for make in (lambda d: gymapi.make_env(d, device="cpu"),
                 lambda d: jgymapi.make_env(JaxEnvConfig.from_dict(d))):
        with pytest.raises(ValueError, match="transport"):
            make(cfg_dict(env_type="gazebo_env"))


def test_time_control_paces_steps():
    """TimeControlWrapper: each step takes at least ``control_hz`` seconds
    of wall clock, as the reference's eval pacing does."""
    import time

    env = gymapi.make_env(cfg_dict(control_hz=0.05, wrapper=WRAPPERS[:-2]
                                   + ["TimeControlWrapper"]), device="cpu")
    env.reset()
    t0 = time.perf_counter()
    for _ in range(4):
        env.step(np.zeros((env.robot_total, 2), np.float32))
    assert time.perf_counter() - t0 >= 3 * 0.05
