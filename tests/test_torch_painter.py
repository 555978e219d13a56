"""Raycast, hit steps, the exact painter (kernel K3's twin), the self stamp
and the 48x48 sensor maps of the torch port vs the JAX package.

JAX runs jitted in float32 from the same occupancy, as in production.  K3's
twin must equal both the JAX dense decode (painter.paint_sorted) and the
transposed Pallas kernel in interpret mode.  A numpy walk of K3's slot rows
(PaintRows, the exact loop csrc/paint.cu runs per robot and row) holds the
kernel's table layout to the twin on the CPU; a walk of K5's 64-slot blocks
(PaintBlocks, csrc/paint_block.cu's loop) does the same for the gen-1
layout, which must also equal the gen-1 Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img_env_tpu.ops import painter as jpainter
from img_env_tpu.ops import polar as jpolar
from img_env_tpu.ops.pallas_paint import (PaintKernelStatics as JPaintK,
                                          paint_sorted_pallas)
from img_env_tpu.ops.pallas_paint_t import (PaintTStatics as JPaintT,
                                            paint_sorted_pallas_t)
from img_env_tpu_torch.ops import painter, polar, view

from tests.test_pallas_paint_t import VP
from tests.test_raster import RES, _layers_from_scene, _random_scene


@pytest.fixture(scope="module")
def statics():
    ps_j = jpolar.PolarStatics.build(VP, n_chunks=8)
    pst_j = jpainter.PainterStatics.build(ps_j)
    ps_t = polar.PolarStatics.build(view.ViewParams(*VP), n_chunks=8)
    pst_t = painter.PainterStatics.build(ps_t)
    kst_t = painter.PaintTStatics.build(pst_t)
    rows = painter.PaintRows.build(kst_t, VP.range_total)
    rng = np.random.default_rng(1)
    own = rng.random((5, ps_t.n_slots)) < 0.05
    return (ps_j, pst_j, JPaintT.build(pst_j), ps_t, pst_t, rows,
            polar.make_tables(ps_t, own, "cpu"),
            painter.make_painter_tables(pst_t, rows, "cpu"), own)


def _occupancy(rng, ps_j):
    static, obs, peds, robots = _random_scene(rng, n_rob=5, n_ped=2,
                                              n_obs=3)
    layers = _layers_from_scene(static, obs, peds, robots)
    poses = np.stack([p for p, _ in robots]).astype(np.float32)
    with jax.enable_x64(False):
        occ = jax.jit(lambda pm, p: jpolar.fill_sorted(ps_j, pm, RES, p))(
            layers.packed, jnp.asarray(poses))
    return np.array(occ)


def _emulate_rows(rows, s_hit, s_tail, n_slots):
    """csrc/paint.cu's loop in numpy: per row, walk the beam window, max
    the key (beam << 2) | code per slot, decode."""
    n = s_hit.shape[0]
    sh, st = s_hit.astype(np.int64), s_tail.astype(np.int64)
    out = np.full((n, n_slots), np.nan, np.float32)
    for r in range(rows.slots.shape[0]):
        acc = np.full((n, painter.G8), -1, np.int64)
        for wp in range(rows.w[r]):
            beam = rows.rb[r] + wp
            T = rows.table[rows.off[r] + wp].astype(np.int64)[None, :]
            h, t = sh[:, beam:beam + 1], st[:, beam:beam + 1]
            code = np.where(T <= 0, 0, np.where(
                T <= h, 2, np.where(T == h + 1, 3, np.where(T > t, 1, 0))))
            acc = np.where(code > 0, np.maximum(acc, (beam << 2) | code), acc)
        c = acc & 3
        val = np.where(acc < 0, 200.0, np.where(
            c == 2, 255.0, np.where(c == 3, 0.0, 200.0)))
        for g, slot in enumerate(rows.slots[r]):
            if slot >= 0:
                out[:, slot] = val[:, g]
    return out


@pytest.mark.parametrize("trial", range(2))
def test_sensor_chain_matches_jax(rng, statics, trial):
    (ps_j, pst_j, kst_j, ps_t, pst_t, rows, t_polar, t_paint,
     own) = statics
    occ = _occupancy(rng, ps_j)
    with jax.enable_x64(False):
        hits_j, ang_j, aux_j = jax.jit(lambda o: jpolar.raycast_batched(
            ps_j, o, return_aux=True))(jnp.asarray(occ))
        sh_j, st_j = jax.jit(lambda *a: jpainter.hit_steps(pst_j, *a))(
            *aux_j)
        vals_j = jax.jit(lambda a, b: jpainter.paint_sorted(pst_j, a, b))(
            sh_j, st_j)
        vals_k = paint_sorted_pallas_t(kst_j, sh_j, st_j, interpret=True)
        stamped_j = jpolar.stamp_self_mask(vals_j, jnp.asarray(own))
        maps_j = jax.jit(lambda v: jpolar.sensor_maps_from_sorted(
            ps_j, v, (48, 48)))(stamped_j)

    hits, ang, aux = polar.raycast_batched(ps_t, t_polar,
                                           torch.as_tensor(occ))
    np.testing.assert_array_equal(hits.numpy(), np.asarray(hits_j))
    np.testing.assert_array_equal(ang.numpy(), np.asarray(ang_j))
    for got, want in zip(aux, aux_j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    s_hit, s_tail = painter.hit_steps(pst_t, t_paint, *aux)
    np.testing.assert_array_equal(s_hit.numpy(), np.asarray(sh_j))
    np.testing.assert_array_equal(s_tail.numpy(), np.asarray(st_j))

    vals = painter.paint(pst_t, t_paint, s_hit, s_tail)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vals_j))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vals_k))
    np.testing.assert_array_equal(
        _emulate_rows(rows, s_hit.numpy(), s_tail.numpy(), pst_t.n_slots),
        vals.numpy())

    stamped = polar.stamp_self_mask(vals, t_polar.own_mask)
    np.testing.assert_array_equal(stamped.numpy(), np.asarray(stamped_j))
    maps = polar.sensor_maps_from_sorted(t_polar, stamped, (48, 48))
    np.testing.assert_array_equal(maps.numpy(), np.asarray(maps_j))


def test_paint_twin_robot_chunks(statics):
    """The chunked twin is chunk-size independent."""
    *_, pst_t, rows, _, t_paint, _ = statics
    rng = np.random.default_rng(3)
    r = VP.range_total
    s_hit = torch.as_tensor(rng.integers(0, 40, (11, r)), dtype=torch.int16)
    s_hit[:, ::3] = 2 ** 14
    s_tail = torch.where(s_hit == 2 ** 14, s_hit, s_hit + torch.as_tensor(
        rng.integers(1, 4, (11, r)), dtype=torch.int16))
    a = painter.paint_sorted(pst_t, t_paint, s_hit, s_tail, robot_chunk=3)
    b = painter.paint_sorted(pst_t, t_paint, s_hit, s_tail, robot_chunk=64)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(
        _emulate_rows(rows, s_hit.numpy(), s_tail.numpy(), pst_t.n_slots),
        a.numpy())


def _emulate_blocks(blocks, s_hit, s_tail, n_slots):
    """csrc/paint_block.cu's loop in numpy: per 64-slot block, walk the
    window (beams clipped to R - 1), max the key (w << 2) | code per slot,
    decode."""
    n, r = s_hit.shape
    sh, st = s_hit.astype(np.int64), s_tail.astype(np.int64)
    out = np.full((n, n_slots), np.nan, np.float32)
    for b in range(blocks.slots.shape[0]):
        acc = np.full((n, 64), -1, np.int64)
        for wp in range(blocks.w[b]):
            beam = min(blocks.rb[b] + wp, r - 1)
            T = blocks.table[blocks.off[b] + wp].astype(np.int64)[None, :]
            h, t = sh[:, beam:beam + 1], st[:, beam:beam + 1]
            code = np.where(T <= 0, 0, np.where(
                T <= h, 2, np.where(T == h + 1, 3, np.where(T > t, 1, 0))))
            acc = np.where(code > 0, np.maximum(acc, (wp << 2) | code), acc)
        c = acc & 3
        val = np.where(acc < 0, 200.0, np.where(
            c == 2, 255.0, np.where(c == 3, 0.0, 200.0)))
        for g, slot in enumerate(blocks.slots[b]):
            if slot >= 0:
                assert np.isnan(out[0, slot]), "slot written twice"
                out[:, slot] = val[:, g]
    return out


@pytest.mark.parametrize("beams", [32, 360])
def test_paint_blocks_layout_matches_twin_and_gen1_kernel(rng, beams):
    """K5's blocks cover every slot once; their walk equals the twin and
    the JAX gen-1 Pallas kernel (paint_mode='block') on the same
    thresholds, which come from a real raycast.  At 360 beams a
    near-sensor slot is "wide" and rides in a pack over all beams."""
    vp = VP._replace(range_total=beams)
    ps_j = jpolar.PolarStatics.build(vp, n_chunks=8)
    pst_j = jpainter.PainterStatics.build(ps_j)
    ps_t = polar.PolarStatics.build(view.ViewParams(*vp), n_chunks=8)
    pst_t = painter.PainterStatics.build(ps_t)
    assert (len(pst_t.wide_slots) > 0) == (beams > 256)
    assert any(reg.W == 0 for reg in pst_t.regions)
    blocks = painter.PaintBlocks.build(pst_t, beams)
    ids = blocks.slots[blocks.slots >= 0]
    assert np.array_equal(np.sort(ids), np.arange(pst_t.n_slots))
    assert blocks.table.shape == (int(blocks.w.sum()), 64)
    t_polar = polar.make_tables(ps_t, np.zeros((5, ps_t.n_slots), bool),
                                "cpu")
    tb = painter.make_painter_tables(pst_t, blocks, "cpu")
    assert tb.blocks is not None and tb.rows is None
    occ = _occupancy(rng, ps_j)
    _, _, aux = polar.raycast_batched(ps_t, t_polar, torch.as_tensor(occ))
    s_hit, s_tail = painter.hit_steps(pst_t, tb, *aux)
    want = painter.paint(pst_t, tb, s_hit, s_tail)
    with jax.enable_x64(False):
        gen1 = paint_sorted_pallas(pst_j, JPaintK.build(pst_j),
                                   jnp.asarray(s_hit.numpy()),
                                   jnp.asarray(s_tail.numpy()),
                                   interpret=True)
    np.testing.assert_array_equal(want.numpy(), np.asarray(gen1))
    np.testing.assert_array_equal(
        _emulate_blocks(blocks, s_hit.numpy(), s_tail.numpy(),
                        pst_t.n_slots), want.numpy())


def test_paint_rows_stay_within_the_beams(rng):
    """K3 reads the thresholds of every beam of a row's window, so no
    window may run past the last beam (the TPU layout pads the beams to a
    multiple of 128: at 96 beams one window used to end at beam 104, and
    at 960 beams the kernel read up to 64 rows past the end of its
    threshold buffers, an illegal address when that buffer ended a mapped
    segment).  The trimmed rows still paint what the twin paints."""
    from img_env_tpu_torch.config import EnvConfig
    from img_env_tpu_torch.env.nav_env import NavEnv

    from tests.test_torch_env import small_cfg_dict

    env = NavEnv(EnvConfig.from_dict(small_cfg_dict()), "cpu")
    st = env.statics
    beams = st.view_params.range_total
    rows = painter.PaintRows.build(st.paint_t, beams)
    assert (rows.rb + rows.w <= beams).all()
    assert rows.table.shape == (int(rows.w.sum()), painter.G8)
    n = 3
    s_hit = torch.as_tensor(rng.integers(0, 40, (n, beams)), dtype=torch.int32)
    s_tail = s_hit + torch.as_tensor(rng.integers(0, 4, (n, beams)),
                                     dtype=torch.int32)
    tb = painter.make_painter_tables(st.painter, rows, "cpu")
    want = painter.paint(st.painter, tb, s_hit, s_tail)
    np.testing.assert_array_equal(
        _emulate_rows(rows, s_hit.numpy(), s_tail.numpy(),
                      st.painter.n_slots), want.numpy())
