"""The port's evaluation outputs (``img_env_tpu_torch.eval.render``,
``live_view`` and ``plots``) against the JAX package's.

The frames, tiles and GUI composites of one state are array-equal to the
JAX functions' on the same state moved to the host; the PNG writer (the
standard library, no cv2 or PIL) round-trips through the port's map
loader and through cv2; the BagReader indicators and the comparison
table equal JAX's on the same recorders; the figures render headless
(Agg), and without matplotlib the table still comes out.
"""

import sys

import numpy as np
import pytest
import torch

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.eval import live_view as jlive
from img_env_tpu.eval import plots as jplots
from img_env_tpu.eval import render as jrender
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.core.convert import world_state_to_numpy
from img_env_tpu_torch.env.maps import decode_png
from img_env_tpu_torch.env.nav_env import NavEnv
from img_env_tpu_torch.eval import live_view, plots, render
from img_env_tpu_torch.eval.recorder import EpisodeRecord, EpisodeRecorder
from tests.test_torch_env import ped_cfg_dict


def _cfg_dict():
    d = ped_cfg_dict(n_rob=7, n_ped=2, n_obs=3)
    d.update(beep_r=0.8, act_dim=3)
    return d


@pytest.fixture(scope="module")
def scene():
    """A stepped 7-robot state with beeps, its observation, the statics and
    both configs."""
    d = _cfg_dict()
    env = NavEnv(EnvConfig.from_dict(d), "cpu", seed=3)
    state, obs = env.reset()
    acts = torch.tensor([[0.3, 0.2, float(i % 2)] for i in range(7)])
    for _ in range(2):
        state, obs, *_ = env.step(state, acts)
    assert bool(state.robots.beep.any())
    return env, state, obs, EnvConfig.from_dict(d), JaxEnvConfig.from_dict(d)


def test_render_frame_and_tiles_match_jax(scene):
    env, state, obs, cfg, _ = scene
    host = world_state_to_numpy(state)
    for kw in ({}, {"beep_radius": 0.8, "draw_goals": False},
               {"robot_radius": 0.3, "ped_radius": 0.05}):
        got = render.render_frame(state, env.statics, **kw)
        want = jrender.render_frame(host, env.statics, **kw)
        assert got.dtype == np.uint8 and got.shape[-1] == 3
        np.testing.assert_array_equal(got, want)
    for maps in (obs.sensor_maps, obs.sensor_maps[:, None].expand(
            -1, 2, -1, -1) * 255.0):
        for tile, per_col in ((96, 5), (40, 3)):
            np.testing.assert_array_equal(
                render.render_tiles(maps, tile, per_col),
                jrender.render_tiles(maps.numpy(), tile, per_col))
    np.testing.assert_array_equal(render.KELLY_COLORS, jrender.KELLY_COLORS)


def test_compose_gui_and_headless_viewer_match_jax(scene, monkeypatch):
    env, state, obs, cfg, jcfg = scene
    host = world_state_to_numpy(state)
    for h in (480, 250):
        np.testing.assert_array_equal(
            live_view.compose_gui(state, env.statics, obs.sensor_maps, cfg,
                                  window_height=h),
            jlive.compose_gui(host, env.statics, obs.sensor_maps.numpy(),
                              jcfg, window_height=h))
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    viewer = live_view.LiveViewer(env.statics, cfg)
    assert viewer.backend == "none"
    img = viewer.update(state, obs.sensor_maps)
    np.testing.assert_array_equal(img, jlive.compose_gui(
        host, env.statics, obs.sensor_maps.numpy(), jcfg))
    viewer.on = False
    assert viewer.update(state, obs.sensor_maps) is None
    assert viewer.last_frame is img
    viewer.close()


def test_save_png_roundtrips_through_the_map_loader_and_cv2(scene,
                                                            tmp_path):
    import cv2

    env, state, *_ = scene
    img = render.render_frame(state, env.statics, beep_radius=0.8)
    grey = np.arange(35 * 17, dtype=np.uint8).reshape(35, 17)
    for name, x in (("frame.png", img), ("grey.png", grey)):
        path = str(tmp_path / name)
        render.save_png(path, x)
        back = decode_png(path)
        np.testing.assert_array_equal(back.reshape(x.shape), x)
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if x.ndim == 3:
            want = want[..., ::-1]
        np.testing.assert_array_equal(want, x)
    with pytest.raises(ValueError):
        render.save_png(str(tmp_path / "bad.png"), np.zeros((4, 4, 2)))


def _recorder(dt=0.25):
    """Four episodes of three robots: arrivals by code and by reach
    distance, static and ped collisions, a timeout, an unlabelled robot
    that never reaches its goal."""
    rng = np.random.default_rng(0)
    rec = EpisodeRecorder(dt=dt)
    codes = [[5, 1, 10], [0, 5, 2], [5, 5, 3], [10, 0, 5]]
    for k, code in enumerate(codes):
        e = EpisodeRecord()
        t = 6 + 3 * k
        start = rng.uniform(1.0, 3.0, (3, 2))
        goal = start + rng.uniform(1.0, 2.0, (3, 2))
        path = start[None] + np.linspace(0, 1, t)[:, None, None] * (
            goal - start)[None]
        if k == 1:
            path[:, 0] = start[0]           # robot 0 never moves: no hit
        yaw = rng.uniform(-3, 3, (t, 3, 1))
        e.robot_poses = list(np.concatenate([path, yaw], -1)
                             .astype(np.float32))
        e.robot_vws = list(rng.uniform(-0.5, 0.6, (t, 3, 2))
                           .astype(np.float32))
        e.ped_poses = list(rng.uniform(0, 5, (t, 2, 2)).astype(np.float32))
        e.goals = goal.astype(np.float32)
        e.dones_info = np.asarray(code)
        rec.episodes.append(e)
    rec.episodes.append(EpisodeRecord())    # an empty record is skipped
    return rec


def test_per_robot_indicators_and_table_match_jax(tmp_path):
    rec = _recorder()
    for v_max, reach in ((0.6, 0.3), (0.5, 0.6)):
        got = plots.per_robot_indicators(rec, v_max, reach)
        assert got == jplots.per_robot_indicators(rec, v_max, reach)
    assert plots.per_robot_indicators(EpisodeRecorder()) == {}
    recs = {"a": rec, "b": _recorder(0.4)}
    table = plots.compare_methods(recs, str(tmp_path / "t"), figures=False)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == [
        "comparison.csv"]
    jtable = jplots.compare_methods(recs, str(tmp_path / "j"))
    assert table == jtable
    assert ((tmp_path / "t" / "comparison.csv").read_text()
            == (tmp_path / "j" / "comparison.csv").read_text())


def test_figures_render_headless(scene, tmp_path):
    """Every figure of the port's plots module renders under Agg, and
    ``compare_methods`` writes what the JAX one writes."""
    env, *_ = scene
    rec = _recorder()
    out = tmp_path / "figs"
    out.mkdir()
    for name, fn in (("traj", lambda p: plots.plot_trajectories(
                         rec, env.statics, out=p)),
                     ("split", lambda p: plots.plot_ep_split(
                         rec, env.statics, out=p)),
                     ("odom", lambda p: plots.plot_vw_odom(rec, 1, 2, out=p)),
                     ("vw", lambda p: plots.plot_vw_curves(rec, 2, out=p)),
                     ("outcomes", lambda p: plots.plot_outcomes(rec, out=p))):
        path = str(out / f"{name}.png")
        assert fn(path) == path
        assert decode_png(path).shape[0] > 50
    with pytest.raises(ValueError):
        plots.plot_ep_split(EpisodeRecorder())
    recs = {"a": rec, "b": _recorder(0.4)}
    plots.compare_methods(recs, str(tmp_path / "t"), statics=env.statics)
    jplots.compare_methods(recs, str(tmp_path / "j"), statics=env.statics)
    assert (sorted(p.name for p in (tmp_path / "t").iterdir())
            == sorted(p.name for p in (tmp_path / "j").iterdir()))


def test_compare_methods_without_matplotlib(tmp_path, monkeypatch):
    """The table and csv need no matplotlib; the figures raise
    ImportError, after the csv is written."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    recs = {"a": _recorder()}
    table = plots.compare_methods(recs, str(tmp_path / "a"), figures=False)
    assert table["a"] == plots.per_robot_indicators(recs["a"])["all"]
    with pytest.raises(ImportError):
        plots.compare_methods(recs, str(tmp_path / "b"))
    assert (tmp_path / "b" / "comparison.csv").exists()
