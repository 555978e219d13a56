"""The port's BARN benchmark (``img_env_tpu_torch.datasets.barn``,
``img_env_tpu_torch.eval.barn``) against the JAX package's.

The worlds are the JAX package's for every seed (both draw from numpy's
``default_rng``); the port writes its PNGs with the standard library and
both packages' loaders read them alike.  The sequential suite under the
straight-at-goal baseline gives the JAX suite's rows and episode lines
exactly; the batched suite with run_barn's MPC profile (the geodesic goal
field) over two worlds of unequal size, with the JAX draws injected,
gives the JAX suite's collision and arrival codes at every step and its
commands within F12's float32 bound (5e-4 a step).
"""

import os

import jax
import numpy as np
import pytest
import torch

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.datasets import barn as jbarn
from img_env_tpu.env import maps as jmaps
from img_env_tpu.eval import barn as jeval_barn
from img_env_tpu.parallel import batched_env as jbatched
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.datasets import barn
from img_env_tpu_torch.env import maps
from img_env_tpu_torch.eval import barn as eval_barn
from img_env_tpu_torch.mpc.controller import MpcController
from img_env_tpu_torch.parallel import batched_env

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "barn_world_fixture.world")


@pytest.mark.parametrize("seed", range(10))
def test_generated_world_equals_jax(seed):
    np.testing.assert_array_equal(barn.generate_barn_world(seed),
                                  jbarn.generate_barn_world(seed))


def test_png_round_trip_and_config(tmp_path):
    """The port's PNG (zlib, struct) decodes to the occupancy with its
    border wall in both packages, the cv2 loader's map at the view
    resolution equals the port's, and ``world_cfg_dict`` is the JAX
    package's dict; a non-square world keeps rows as x."""
    occ = barn.generate_barn_world(4, rows=36, cols=30)
    mine, theirs = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    barn.save_world_png(mine, occ)
    jbarn.save_world_png(theirs, occ)
    want = np.pad(np.where(occ, 0, 255), 1).astype(np.uint8)
    for path in (mine, theirs):
        np.testing.assert_array_equal(maps.decode_png(path)[..., 0], want)
    d = barn.world_cfg_dict(mine)
    assert d == jbarn.world_cfg_dict(mine)
    cell = barn.CELL_M
    assert d["robot"]["target_poses"] == [[38 * cell - 4 * cell,
                                           32 * cell / 2]]
    np.testing.assert_array_equal(
        maps.load_static_map(EnvConfig.from_dict(d)),
        jmaps.load_static_map(JaxEnvConfig.from_dict(d)))


def test_convert_real_barn_world_equals_jax(tmp_path):
    grid = barn.convert_barn_world(FIXTURE)
    np.testing.assert_array_equal(grid, jbarn.convert_barn_world(FIXTURE))
    png = barn.convert_barn_worlds([FIXTURE], str(tmp_path))[0]
    inner = maps.decode_png(png)[1:-1, 1:-1, 0]
    np.testing.assert_array_equal(inner < 250, grid == barn.OBST)


def _straight_policy_j(key, obs):
    """run_barn.py's straight-at-goal baseline for the JAX suite."""
    vec = np.asarray(obs[1] if isinstance(obs, list) else
                     obs.vector_states).reshape(-1)[-3:]
    w = float(np.clip(np.arctan2(vec[1], vec[0]), -0.9, 0.9))
    return np.asarray([[0.5, w]])


def test_sequential_suite_equals_jax(tmp_path):
    """``run_barn_suite`` over a generated world under the straight-at-goal
    baseline, two episodes: the same rows (but wall time) and the same
    reference-format episode lines."""
    worlds = barn.generate_worlds(str(tmp_path / "w"), n=1, seed0=3)
    d = barn.world_cfg_dict(worlds[0], n_beams=48)
    d["time_max"] = 25
    kw = dict(episodes_per_world=2, max_steps=30)
    with jax.enable_x64(False):
        want = jeval_barn.run_barn_suite(
            worlds, JaxEnvConfig.from_dict(d),
            _straight_policy_j,
            output_txt=str(tmp_path / "j.txt"), **kw)
    got = eval_barn.run_barn_suite(
        worlds, EnvConfig.from_dict(d), eval_barn.straight_policy,
        output_txt=str(tmp_path / "t.txt"), output_csv=str(tmp_path / "t.csv"),
        device="cpu", **kw)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "wall_s"} == \
            {k: v for k, v in w.items() if k != "wall_s"}
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert got[0]["episodes"] == 2


def _unequal_worlds(tmp_path):
    """World 0 (the env's configured map) 30 x 30 cells, world 1 36 x 30:
    world 0 is padded to world 1's 113 x 95 view grid."""
    a = str(tmp_path / "barn_world_0.png")
    b = str(tmp_path / "barn_world_1.png")
    barn.save_world_png(a, barn.generate_barn_world(0))
    barn.save_world_png(b, barn.generate_barn_world(7, rows=36))
    return [a, b]


def test_batched_mpc_suite_matches_jax(tmp_path, monkeypatch):
    """Two worlds of unequal size, run_barn's MPC profile, 2 episodes of at
    most 3 steps (the time limit ends each, so every world is redrawn with
    its state carried): the JAX suite free running, the port fed the JAX
    suite's MPPI draws (its key chain rebuilt from the steps at which it
    redrew).  Per step the collision and arrival codes are equal and the
    commands within 5e-4; the rows are equal but for wall time."""
    from img_env_tpu.mpc import MppiConfig as JaxMppiConfig
    from img_env_tpu.mpc.cost import CostWeights as JaxCostWeights

    worlds = _unequal_worlds(tmp_path)
    d = barn.world_cfg_dict(worlds[0], n_beams=48)
    np.testing.assert_array_equal(
        eval_barn.load_padded_maps(worlds, EnvConfig.from_dict(d))[0, 95:], 0)
    mc, w8 = eval_barn.corridor_profile()
    kw = dict(episodes_per_world=2, max_steps=3, seed=0)

    log_j = {"acts": [], "codes": [], "redraw_after": []}
    real_step, real_reset = jbatched.BatchedNavEnv.step, \
        jbatched.BatchedNavEnv.reset

    def step_j(self, states, actions):
        out = real_step(self, states, actions)
        log_j["acts"].append(np.asarray(actions)[..., :2])
        log_j["codes"].append((np.asarray(out[1].is_collisions),
                               np.asarray(out[1].is_arrives)))
        return out

    def reset_j(self, keys, carry=None, static_maps=None):
        if carry is not None:
            log_j["redraw_after"].append(len(log_j["acts"]))
        return real_reset(self, keys, carry, static_maps)

    monkeypatch.setattr(jbatched.BatchedNavEnv, "step", step_j)
    monkeypatch.setattr(jbatched.BatchedNavEnv, "reset", reset_j)
    with jax.enable_x64(False):
        want = jeval_barn.run_barn_suite_batched(
            worlds, JaxEnvConfig.from_dict(d),
            mpc=JaxMppiConfig(**mc._asdict()),
            mpc_weights=JaxCostWeights(**w8._asdict()), **kw)
        # the suite's key chain: one split a step, one more after a redraw
        noises, key = [], jax.random.PRNGKey(kw["seed"])
        key, _ = jax.random.split(key)
        for t in range(1, len(log_j["acts"]) + 1):
            key, k = jax.random.split(key)
            noises.append(np.concatenate([
                np.array(jax.random.normal(jax.random.split(kk, 1)[0],
                                           (mc.samples, mc.horizon, 2)))[None]
                for kk in jax.random.split(k, len(worlds))]))
            if t in log_j["redraw_after"]:
                key, _ = jax.random.split(key)
    assert log_j["redraw_after"] == [3, 6]

    queue = [torch.as_tensor(x) for x in noises]
    monkeypatch.setattr(MpcController, "draw_noise",
                        lambda self, dtype=None, scenes=1: queue.pop(0))
    log_t = {"acts": [], "codes": []}
    real_step_t = batched_env.BatchedNavEnv.step

    def step_t(self, states, actions, beep_u=None):
        out = real_step_t(self, states, actions, beep_u)
        log_t["acts"].append(actions[..., :2].numpy())
        log_t["codes"].append((out[1].is_collisions.numpy(),
                               out[1].is_arrives.numpy()))
        return out

    monkeypatch.setattr(batched_env.BatchedNavEnv, "step", step_t)
    got = eval_barn.run_barn_suite_batched(
        worlds, EnvConfig.from_dict(d), mpc=mc, mpc_weights=w8,
        device="cpu", **kw)
    assert not queue and len(log_t["acts"]) == len(log_j["acts"]) == 6
    for (ct, at), (cj, aj) in zip(log_t["codes"], log_j["codes"]):
        np.testing.assert_array_equal(ct, cj)
        np.testing.assert_array_equal(at, aj)
    for a_t, a_j in zip(log_t["acts"], log_j["acts"]):
        np.testing.assert_allclose(a_t, a_j, atol=5e-4, rtol=0)
    assert np.abs(log_j["acts"][0]).max() > 0.1            # the robots move
    for g, w in zip(got, want):
        for k in g:
            if k not in ("wall_s", "avg_v", "avg_w"):
                assert g[k] == w[k], k
        assert np.isnan(g["avg_v"]) and np.isnan(w["avg_v"])


def test_chunks_seed_by_offset_and_leave_speeds_nan(tmp_path, monkeypatch):
    """The reference's per-chunk seed ``seed + c0`` and its NaN speeds on
    the batched path (ROADMAP F9), kept: two worlds in chunks of one."""
    worlds = barn.generate_worlds(str(tmp_path), n=2, seed0=11)
    seeds = []
    real_init = batched_env.BatchedNavEnv.__init__

    def init(self, cfg, device="cuda", seed=0, **kw):
        seeds.append(seed)
        real_init(self, cfg, device, seed, **kw)

    monkeypatch.setattr(batched_env.BatchedNavEnv, "__init__", init)
    rows = eval_barn.run_barn_suite_batched(
        worlds, EnvConfig.from_dict(barn.world_cfg_dict(worlds[0], 32)),
        eval_barn.straight_policy_batched, episodes_per_world=1,
        max_steps=1, seed=5, chunk=1, device="cpu")
    assert seeds == [5, 6]
    assert [r["episodes"] for r in rows] == [1, 1]
    assert all(np.isnan(r["avg_v"]) and np.isnan(r["avg_w"]) for r in rows)
