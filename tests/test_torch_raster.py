"""Raster (kernel K1's twin), layer packing and collision codes of the torch
port vs the JAX package.

The JAX side runs jitted in float32 (the production program: under jit XLA
divides by the constant resolution through its f32 reciprocal, which the
port reproduces).  K1's plain-torch twin is held to the Pallas kernel in
interpret mode, the way tests/test_pallas_raster.py runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img_env_tpu.ops import raster as jraster
from img_env_tpu.ops.pallas_raster import robot_maps_pallas
from img_env_tpu_torch.ops import raster

from tests.test_pallas_raster import HW, _scene
from tests.test_raster import RES, _pad, _random_scene


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.mark.parametrize("trial", range(3))
def test_robot_maps_twin_matches_pallas_kernel(rng, trial):
    pts, msk, poses = _scene(rng)
    with jax.enable_x64(False):
        cells = jax.jit(lambda p, q: jraster.world_to_cell(
            jraster.transform_points(p, q), RES))(
                jnp.asarray(poses, jnp.float32), jnp.asarray(pts))
        want_cnt, want_id = robot_maps_pallas(
            cells, jnp.asarray(msk), h=HW[0], w=HW[1], interpret=True)
    cnt, id_sum = raster.robot_maps(_t(cells), _t(msk), *HW)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_array_equal(id_sum.numpy(), np.asarray(want_id))
    assert cnt.max() >= 2                      # the scene forces overlaps


def test_robot_maps_twin_scene_axis_matches_vmapped_pallas_kernel(rng):
    """K1's twin over a scene axis (S=3 scenes of the same 6 robots at
    other poses, as the batch env rasters them in one launch) against the
    Pallas kernel vmapped over scenes, as the JAX package's
    ``_observe_multi`` runs it; each scene's ids are in-scene ids."""
    pts, msk, _ = _scene(rng)
    poses = np.stack([_scene(rng)[2] for _ in range(3)])       # [3, 6, 3]
    with jax.enable_x64(False):
        cells = jax.jit(jax.vmap(lambda p: jraster.world_to_cell(
            jraster.transform_points(p, jnp.asarray(pts)), RES)))(
                jnp.asarray(poses, jnp.float32))
        want_cnt, want_id = jax.vmap(lambda c: robot_maps_pallas(
            c, jnp.asarray(msk), h=HW[0], w=HW[1], interpret=True))(cells)
    cnt, id_sum = raster.robot_maps(_t(cells), _t(msk), *HW)
    assert cnt.shape == (3,) + tuple(HW)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_array_equal(id_sum.numpy(), np.asarray(want_id))
    assert not torch.equal(cnt[0], cnt[1])


def _scene_arrays(static, obs, peds, robots):
    """tests/test_raster._layers_from_scene's inputs as numpy arrays."""
    obs_poses = np.stack([p for p, _ in obs])
    obs_pts, obs_msk = _pad([c for _, c in obs])
    rob_poses = np.stack([p for p, _ in robots])
    rob_pts, rob_msk = _pad([c for _, c in robots])
    ped_poses = np.stack([p for p, _, _ in peds])
    body, lefts, rights = [], [], []
    for pose, kind, payload in peds:
        empty = np.zeros((0, 2), np.float32)
        if kind == "circle":
            body.append(payload)
            lefts.append(empty)
            rights.append(empty)
        else:
            lb, rb, loff, roff = payload
            body.append(empty)
            lefts.append(lb + np.asarray(loff, np.float32))
            rights.append(rb + np.asarray(roff, np.float32))
    f = lambda a: np.asarray(a, np.float32)
    return ((static, f(obs_poses), obs_pts, obs_msk),
            (f(rob_poses), rob_pts, rob_msk, f(ped_poses), *_pad(body),
             *_pad(lefts), *_pad(rights)))


def _jax_layers(obs_args, layer_args):
    with jax.enable_x64(False):
        obs_map = jax.jit(lambda s, p, q, m: jraster.draw_obstacles(
            s, RES, p, q, m))(*obs_args)
        layers = jax.jit(lambda om, *a: jraster.build_layers(
            om, RES, *a, robots_pallas=False))(obs_map, *layer_args)
    return obs_map, layers


@pytest.mark.parametrize("trial", range(3))
def test_build_layers_and_collision_codes(rng, trial):
    static, obs, peds, robots = _random_scene(rng)
    obs_args, layer_args = _scene_arrays(static, obs, peds, robots)
    obs_map_j, layers_j = _jax_layers(obs_args, layer_args)

    obs_map = raster.draw_obstacles(_t(obs_args[0]), RES,
                                    *(_t(a) for a in obs_args[1:]))
    np.testing.assert_array_equal(obs_map.numpy(), np.asarray(obs_map_j))
    layers = raster.build_layers(obs_map, RES,
                                 *(_t(a) for a in layer_args))

    # the id field is an id-SUM here and the max id in the XLA scatters:
    # mask it where two or more robots cover a cell (only count == 1 cells
    # ever decode it)
    want = np.asarray(layers_j.packed)
    got = layers.packed.numpy()
    overlap = ((want >> 1) & 3) >= 2
    id_mask = np.where(overlap, ~(0xFFF << 3), -1)
    np.testing.assert_array_equal(got & id_mask, want & id_mask)
    np.testing.assert_array_equal(layers.robot_count.numpy(),
                                  np.asarray(layers_j.robot_count))
    np.testing.assert_array_equal(layers.robot_cells.numpy(),
                                  np.asarray(layers_j.robot_cells))

    n = len(robots)
    latched = np.zeros(n, np.int32)
    arrived = np.zeros(n, bool)
    latched[-1], arrived[-2] = 2, True
    for lat, arr in ((np.zeros(n, np.int32), np.zeros(n, bool)),
                     (latched, arrived)):
        with jax.enable_x64(False):
            want_c = jax.jit(jraster.collision_codes)(
                layers_j, jnp.asarray(lat), jnp.asarray(arr))
        got_c = raster.collision_codes(layers, _t(lat), _t(arr))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_round_half_away_and_span_check():
    x = torch.tensor([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.4, -0.4])
    np.testing.assert_array_equal(raster.round_half_away(x).numpy(),
                                  [-3, -2, -1, 1, 2, 3, 0, 0])
    pts = np.array([[[0.0, 0.0], [0.9, 0.0]]], np.float32)
    assert raster.check_footprint_span(pts, 0.015) == 122
    with pytest.raises(ValueError):
        raster.check_footprint_span(pts, 0.01)
