"""The port against the native C++ oracle (``cpp/oracle.cpp`` through
``img_env_tpu.oracle.cpp_oracle``): drawing, the robot command (omni and
diff-drive) and the egocentric view with and without lasers, from the
same inputs, held as ``tests/test_cpp_oracle.py`` holds the numpy oracle:
maps and views bit for bit, poses and velocities within 1e-12, arrivals
equal; the laser hits and the angular map, which the port reads from a
float32 table, equal to the oracle's rounded to float32.

The oracle computes in float64, and so does the port here: the obstacle
draw (``raster.draw_obstacles``), ``batched_robot_cmd`` and the view
pipeline (``polar.fill_sorted``'s twin, the raycast, the painter's twin;
the view map before the self stamp, unsorted to the image) run on float64
poses.  Skipped like ``tests/test_cpp_oracle.py`` where g++ cannot build
the oracle.
"""

import numpy as np
import pytest
import torch

from img_env_tpu.oracle import cpp_oracle
from img_env_tpu_torch.config import SpeedLimiterConfig
from img_env_tpu_torch.dynamics.kinematics import batched_robot_cmd
from img_env_tpu_torch.dynamics.limiter import LimiterParams
from img_env_tpu_torch.ops import painter, polar, raster, view
from img_env_tpu_torch.ops.footprint import circle_points

RES = 0.05
HPX = 60


@pytest.fixture(scope="module")
def oracle():
    if not cpp_oracle.available():
        pytest.skip("g++ toolchain unavailable")
    return cpp_oracle


def scene(rng, h=80, w=80):
    """tests/test_cpp_oracle.py's grid: free, with 6 blocks of 0, 1 or 2."""
    grid = np.full((h, w), 255, np.uint8)
    for _ in range(6):
        m, n = rng.integers(5, h - 5), rng.integers(5, w - 5)
        grid[m - 2:m + 2, n - 2:n + 2] = rng.choice([0, 1, 2])
    return grid


def test_draw_matches_oracle(rng, oracle):
    grid = scene(rng)
    pose = np.asarray([2.0, 2.0, 0.7])
    pts = np.asarray(circle_points(0.0, 0.0, 0.17), np.float64)
    want = grid.copy()
    oracle.draw(want, RES, pose, pts, 0)
    got = raster.draw_obstacles(
        torch.as_tensor(grid), RES, torch.as_tensor(pose)[None],
        torch.as_tensor(pts)[None],
        torch.ones((1, pts.shape[0]), dtype=torch.bool))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != grid).any()


@pytest.mark.parametrize("omni", [0, 1], ids=["diff", "omni"])
def test_cmd_matches_oracle(rng, oracle, omni):
    """6 commands in a row from tests/test_cpp_oracle.py's limiters
    (velocity and acceleration limits)."""
    lim = lambda lo, hi: LimiterParams.from_config(SpeedLimiterConfig(
        has_velocity_limits=True, has_acceleration_limits=True,
        has_jerk_limits=False, min_velocity=lo, max_velocity=hi,
        min_acceleration=-2.0, max_acceleration=2.0))
    lv, lw = lim(0.0, 0.6), lim(-0.9, 0.9)
    lim_v = np.asarray([1, 1, 0.0, 0.6, -2.0, 2.0], np.float64)
    lim_w = np.asarray([1, 1, -0.9, 0.9, -2.0, 2.0], np.float64)
    pose = np.asarray([1.0, 1.0, 0.3])
    goal = np.asarray([1.8, 1.2])
    last0, last1, vel = np.zeros(2), np.zeros(2), np.zeros(2)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float64))[None]
    for _ in range(6):
        v, w, vy = (rng.uniform(0, 0.6), rng.uniform(-0.9, 0.9),
                    rng.uniform(-0.2, 0.2))
        w_pose, w_l0, w_l1, w_vel, w_arr = oracle.cmd(
            pose.copy(), goal, last0.copy(), last1.copy(), v, w, vy, 0.4,
            omni, lim_v, lim_w)
        g_pose, g_l0, g_l1, g_vel, g_arr = batched_robot_cmd(
            t(pose), t(goal), t(last0), t(last1), t(vel), t(v)[0], t(w)[0],
            t(vy)[0], torch.ones(1, dtype=torch.bool), lv, lw, 0.4, 9,
            "omni" if omni else "diff")
        np.testing.assert_allclose(g_pose[0].numpy(), w_pose, rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(g_vel[0].numpy(), np.asarray(w_vel),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(g_l0[0].numpy(), w_l0, rtol=0,
                                   atol=1e-12)
        assert bool(g_arr[0]) == bool(w_arr)
        pose, last0, last1 = w_pose, w_l0, w_l1
        vel = np.asarray(w_vel, np.float64)


def _port_view(grid, pose, vp):
    """The port's sensor chain for one robot at ``pose`` on ``grid`` (no
    other robot, no ped): the fill of the id-packed map, then the raycast
    and painter (lasers) or the plain values, unsorted to the
    [hpx, wpx] image before the self stamp; with the hits and the angular
    map."""
    ps = polar.PolarStatics.build(vp)
    t = polar.make_tables(ps, np.zeros((1, ps.n_slots), bool), "cpu")
    g = torch.as_tensor(grid)
    zero = torch.zeros(grid.shape, dtype=torch.int32)
    packed = raster.pack_layers(g, zero.bool(), zero.bool(), zero,
                                zero)[None]
    poses = torch.as_tensor(pose)[None]
    occ = polar.fill_sorted(ps, t, packed, poses, RES, None)
    if vp.use_laser:
        hits, ang, aux = polar.raycast_batched(ps, t, occ)
        pst = painter.PainterStatics.build(ps)
        tp = painter.make_painter_tables(pst, painter.PaintSlots.build(pst),
                                         "cpu")
        vals = painter.paint(pst, tp, *painter.hit_steps(pst, tp, *aux))
    else:
        hits = ang = None
        inside = polar.inside_sorted(ps, t, grid.shape, poses, RES)
        vals = polar.plain_values_sorted(t, occ, inside)
    img = vals[0][torch.as_tensor(ps.slot_of_pixel, dtype=torch.int64)]
    return img.reshape(vp.hpx, vp.wpx).numpy().astype(np.uint8), hits, ang


@pytest.mark.parametrize("laser", [True, False], ids=["laser", "no_laser"])
def test_view_matches_oracle(rng, oracle, laser):
    """tests/test_cpp_oracle.py's views: 60 x 60 at 0.05 m with 90 beams,
    40 x 40 with 30 beams and no laser trace."""
    grid = scene(rng)
    hpx, beams, pose = ((HPX, 90, [2.0, 2.0, 0.9]) if laser
                        else (40, 30, [1.5, 2.5, -0.4]))
    pose = np.asarray(pose)
    vp = view.ViewParams(hpx=hpx, wpx=hpx, resolution=RES, half=hpx * RES / 2,
                         angle_begin=-1.570795, angle_end=1.570795,
                         min_dist=0.0, max_dist=10.0, range_total=beams,
                         use_laser=laser)
    want_view, want_hits, want_ang = oracle.view(
        grid, RES, pose, hpx, hpx, RES, hpx * RES / 2, -1.570795, 1.570795,
        0.0, 10.0, beams, laser)
    got_view, hits, ang = _port_view(grid, pose, vp)
    np.testing.assert_array_equal(got_view, want_view)
    if laser:
        # the port's hit distances are a float32 table (PolarStatics.
        # refine_dist): the oracle's float64 distances, rounded once
        assert hits.dtype == ang.dtype == torch.float32
        np.testing.assert_array_equal(hits[0].numpy(),
                                      want_hits.astype(np.float32))
        np.testing.assert_array_equal(ang[0].numpy(),
                                      want_ang.astype(np.float32))
        assert (want_hits < 6.0).any()
