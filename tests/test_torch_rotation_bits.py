"""The rotation of the raster and of the FOV fill against the JAX package's
bits, at the bench200 view scale.

The JAX package's CPU build takes a robot's sin/cos from glibc's
``sinf``/``cosf`` and contracts each rotation row into one fused
multiply-add, ``fma(c, bx, -(s*by)) + px`` and ``fma(s, bx, c*by) + py``.
The port computes the same bits (ops/f32.py): its raster cells and its
fill (kernel K2's twin) equal JAX's jitted paths for 200 random poses
on the gated slots of the bench200 view (400x400 at 0.015 m, 960 beams).
The plain float32 form (torch's sin/cos, no contraction) differs from JAX
on these inputs, so the test can see the fault it guards.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img_env_tpu.ops import polar as jpolar
from img_env_tpu.ops import raster as jraster
from img_env_tpu_torch.ops import polar, raster, view

RES = 0.015          # bench200's world and view resolution
N_POSES = 200
MAP = 1066           # bench200's map side (16 m at 0.015 m)


@pytest.fixture(scope="module")
def slots():
    """The base-frame coordinates [P] f32 of the bench200 view's gated
    prefix, the slots K2 fills: 80,000 slots of the 0.015 m grid within
    the +-3 m view and 12,672 pads far off any map."""
    vp = view.ViewParams(hpx=400, wpx=400, resolution=RES, half=3.0,
                         angle_begin=-1.570795, angle_end=1.570795,
                         min_dist=0.0, max_dist=10.0, range_total=960,
                         use_laser=True)
    ps = polar.PolarStatics.build(vp)
    nf = int(ps.n_fill_slots)
    return (np.asarray(ps.pix_x_sorted[:nf], np.float32),
            np.asarray(ps.pix_y_sorted[:nf], np.float32))


def _poses(seed):
    """200 f32 poses over bench200's room; half the yaws in [-pi, pi],
    half unwrapped in [-20, 20] (a robot that keeps turning)."""
    rng = np.random.default_rng(seed)
    yaw = np.concatenate([rng.uniform(-np.pi, np.pi, N_POSES // 2),
                          rng.uniform(-20.0, 20.0, N_POSES // 2)])
    return np.stack([rng.uniform(0.5, 15.5, N_POSES),
                     rng.uniform(0.5, 15.5, N_POSES), yaw],
                    -1).astype(np.float32)


def _plain_cells(poses, bx, by):
    """The plain float32 form: torch's sin/cos, every product and sum
    rounded on its own."""
    c, s = torch.cos(poses[:, 2:3]), torch.sin(poses[:, 2:3])
    x = c * bx - s * by + poses[:, 0:1]
    y = s * bx + c * by + poses[:, 1:2]
    return raster.world_to_cell(torch.stack([x, y], -1), RES)


def test_raster_cells_equal_jax(slots):
    """``world_to_cell(transform_points(...))``, the cells of every
    footprint point, obstacle point and ped leg point the raster draws, on
    the view's 80,000 grid slots as points."""
    bx, by = slots
    on_grid = np.abs(bx) < 100
    bx, by = bx[on_grid], by[on_grid]
    poses = _poses(0)
    pts = np.stack([bx, by], -1)[None]
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(lambda p, q: jraster.world_to_cell(
            jraster.transform_points(p, q), RES))(jnp.asarray(poses),
                                                  jnp.asarray(pts)))
    got = raster.world_to_cell(raster.transform_points(
        torch.as_tensor(poses), torch.as_tensor(pts)), RES).numpy()
    assert got.shape == want.shape == (N_POSES, len(bx), 2)
    diff = (got != want).any(-1)
    assert diff.sum() == 0, (f"{diff.sum()} of {diff.size} cells differ, at "
                             f"{diff.any(-1).sum()} of {N_POSES} robots")
    plain = _plain_cells(torch.as_tensor(poses), torch.as_tensor(bx)[None],
                         torch.as_tensor(by)[None]).numpy()
    assert (plain != want).any(-1).sum() > 0


def test_fill_equals_jax(slots):
    """``polar.fill_sorted`` (its pose terms and K2's twin) against the
    JAX package's jitted XLA fill on a 1066^2 map with half its cells
    static."""
    bx, by = slots
    nf = len(bx)
    poses = _poses(1)
    rng = np.random.default_rng(2)
    packed = (rng.random((MAP, MAP)) < 0.5).astype(np.int32)
    ps_j = types.SimpleNamespace(pix_x_sorted=bx, pix_y_sorted=by)
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(lambda pm, p: jpolar.fill_sorted(
            ps_j, pm, RES, p))(jnp.asarray(packed), jnp.asarray(poses)))
    ps_t = types.SimpleNamespace(n_fill_slots=nf)
    t = types.SimpleNamespace(pix_x=torch.as_tensor(bx),
                              pix_y=torch.as_tensor(by))
    got = polar.fill_sorted(ps_t, t, torch.as_tensor(packed),
                            torch.as_tensor(poses), RES).numpy()
    assert got.shape == want.shape == (N_POSES, nf)
    diff = got != want
    assert diff.sum() == 0, (f"{diff.sum()} of {diff.size} slots differ, at "
                             f"{diff.any(-1).sum()} of {N_POSES} robots")
    assert 0.3 < got.mean() < 0.6
    cells = _plain_cells(torch.as_tensor(poses), torch.as_tensor(bx)[None],
                         torch.as_tensor(by)[None]).numpy()
    m, n = cells[..., 0], cells[..., 1]
    inside = (m >= 0) & (m < MAP) & (n >= 0) & (n < MAP)
    plain = inside & (packed[m.clip(0, MAP - 1), n.clip(0, MAP - 1)] > 0)
    assert (plain != want).sum() > 0


def test_beam_directions_equal_jax():
    """The lasers' beam directions (hit points = hit range x direction):
    XLA folds the JAX package's cos/sin of the constant beam angles at
    compile time, correctly rounded; the port's table has those bits for
    bench200's 960 beams (a float32 cos/sin differs on ~5% of them)."""
    from img_env_tpu_torch.config import EnvConfig
    from img_env_tpu_torch.env.nav_env import NavEnv

    from tests.test_torch_env import small_cfg_dict

    env = NavEnv(EnvConfig.from_dict(dict(small_cfg_dict(), range_total=960)),
                 "cpu")
    ang = np.asarray(env.statics.view_statics.laser.angles)
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(lambda: jnp.stack(
            [jnp.cos(jnp.asarray(ang)), jnp.sin(jnp.asarray(ang))], -1))())
    np.testing.assert_array_equal(env.tables.beam_dirs.numpy(), want)
    a = torch.as_tensor(ang, dtype=torch.float32)
    plain = torch.stack([torch.cos(a), torch.sin(a)], -1).numpy()
    assert (plain != want).sum() > 0


def test_obstacle_corners_equal_jax():
    """The reset's obstacle corners (``state.obstacles.aabb``, which the
    reset test holds exactly): the same rotation, the same bits, for 2,000
    obstacles, circles and rectangles, at any yaw."""
    from img_env_tpu.env import sampler as jsampler
    from img_env_tpu_torch.env import sampler

    rng = np.random.default_rng(3)
    m = 2000
    pose = np.stack([rng.uniform(0.5, 15.5, m), rng.uniform(0.5, 15.5, m),
                     rng.uniform(-np.pi, np.pi, m)], -1).astype(np.float32)
    lo = rng.uniform(-0.3, -0.1, (m, 2))
    hi = rng.uniform(0.1, 0.3, (m, 2))
    spec = types.SimpleNamespace(
        obs_size_range=np.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]],
                                -1).astype(np.float32),
        obs_shape_circle=np.arange(m) % 2 == 0)
    r = rng.uniform(0.1, 0.2, m).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(lambda p, c: jsampler.obstacle_corners(
            p, spec, c))(jnp.asarray(pose), jnp.asarray(r)))
    got = sampler.obstacle_corners(torch.as_tensor(pose), spec,
                                   torch.as_tensor(r)).numpy()
    np.testing.assert_array_equal(got, want)
