"""Raycast, hit steps, the exact painter (kernel K3's twin), the self stamp
and the 48x48 sensor maps of the torch port vs the JAX package.

JAX runs jitted in float32 from the same occupancy, as in production.  K3's
twin must equal both the JAX dense decode (painter.paint_sorted) and the
transposed Pallas kernel in interpret mode.  A numpy walk of K3's per-slot
visit lists (PaintSlots, the exact loop csrc/paint.cu runs per robot and
slot over its slot-order tiles) holds the kernel's layout to the twin on
the CPU, on real and forced thresholds; a walk of K5's 64-slot blocks
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
    slots = painter.PaintSlots.build(pst_t)
    rng = np.random.default_rng(1)
    own = rng.random((5, ps_t.n_slots)) < 0.05
    return (ps_j, pst_j, JPaintT.build(pst_j), ps_t, pst_t, slots,
            polar.make_tables(ps_t, own, "cpu"),
            painter.make_painter_tables(pst_t, slots, "cpu"), own)


def _occupancy(rng, ps_j):
    static, obs, peds, robots = _random_scene(rng, n_rob=5, n_ped=2,
                                              n_obs=3)
    layers = _layers_from_scene(static, obs, peds, robots)
    poses = np.stack([p for p, _ in robots]).astype(np.float32)
    with jax.enable_x64(False):
        occ = jax.jit(lambda pm, p: jpolar.fill_sorted(ps_j, pm, RES, p))(
            layers.packed, jnp.asarray(poses))
    return np.array(occ)


TILE, SPT = 1024, 4          # csrc/paint.cu: slots per block and thread


def _tile_slots(n_slots):
    """The slots csrc/paint.cu's grid writes, block by block and thread by
    thread (j0 = tile * TILE + thread * SPT, SPT slots each)."""
    tiles = (n_slots + TILE - 1) // TILE
    j0 = (np.arange(tiles)[:, None] * TILE
          + np.arange(TILE // SPT)[None, :] * SPT).reshape(-1)
    j0 = j0[j0 < n_slots]
    return (j0[:, None] + np.arange(SPT)[None, :]).reshape(-1)


def _emulate_slots(slots, s_hit, s_tail, n_slots):
    """csrc/paint.cu's loop in numpy: per robot and slot, walk the slot's
    visits in layout order and take the first that writes (code 2 -> 255,
    3 -> 0, 1 -> 200); no writer -> 200."""
    sh, st = s_hit.astype(np.int64), s_tail.astype(np.int64)
    beam = slots.visits.astype(np.int64) >> 16
    T = (slots.visits & 0xFFFF).astype(np.int64)[None]
    h, t = sh[:, beam], st[:, beam]
    val = np.where(T <= h, 255.0, np.where(T == h + 1, 0.0, np.where(
        T > t, 200.0, np.nan)))
    out = np.full((sh.shape[0], n_slots), np.nan, np.float32)
    for j in _tile_slots(n_slots):
        assert np.isnan(out[0, j]), "slot written twice"
        if slots.off[j] == slots.off[j + 1]:
            out[:, j] = 200.0             # no visitor: no walk
            continue
        writes = ~np.isnan(val[:, slots.off[j]:slots.off[j + 1]])
        first = slots.off[j] + writes.argmax(1)
        out[:, j] = np.where(writes.any(1), val[np.arange(len(first)), first],
                             200.0)
    return out


@pytest.mark.parametrize("trial", range(2))
def test_sensor_chain_matches_jax(rng, statics, trial):
    (ps_j, pst_j, kst_j, ps_t, pst_t, slots, t_polar, t_paint,
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
        _emulate_slots(slots, s_hit.numpy(), s_tail.numpy(), pst_t.n_slots),
        vals.numpy())

    stamped = polar.stamp_self_mask(vals, t_polar.own_mask)
    np.testing.assert_array_equal(stamped.numpy(), np.asarray(stamped_j))
    maps = polar.sensor_maps_from_sorted(t_polar, stamped, (48, 48))
    np.testing.assert_array_equal(maps.numpy(), np.asarray(maps_j))


def test_paint_twin_robot_chunks(statics):
    """The chunked twin is chunk-size independent."""
    *_, pst_t, slots, _, t_paint, _ = statics
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
        _emulate_slots(slots, s_hit.numpy(), s_tail.numpy(), pst_t.n_slots),
        a.numpy())


# csrc/paint_block.cu: robots a block (a wide block's), warps a block
ROBOTS, WIDE_ROBOTS, WARPS = 64, 4, 8


def _block_lists(blocks, b):
    """Block b's per-slot visit lists as csrc/paint_block.cu compacts
    them: warp k scans window positions [lo, hi) downwards (hi = w - k *
    span), and each slot's visits are stored warp by warp, so the list is
    (wp, T) in descending wp; each list is checked to hold exactly the
    slot's visits of the table."""
    w = int(blocks.w[b])
    tab = blocks.table[blocks.off[b]:blocks.off[b] + w].astype(np.int64)
    span = -(-w // WARPS)
    lists = [[] for _ in range(64)]
    for k in range(WARPS):
        hi = max(w - k * span, 0)
        for row in range(hi - 1, max(hi - span, 0) - 1, -1):
            for j in np.nonzero(tab[row])[0]:
                lists[j].append((row, int(tab[row, j])))
    for j, lst in enumerate(lists):
        rows = [wp for wp, _ in lst]
        assert rows == sorted(np.nonzero(tab[:, j])[0].tolist(), reverse=True)
    return lists


def _emulate_blocks(blocks, s_hit, s_tail, n_slots):
    """csrc/paint_block.cu's walk in numpy, block by block in the layout's
    order (the n_wide blocks with windows wider than NARROW_W first, 4
    robots at a time, then the others 64 at a time): per robot and slot,
    the slot's visits in descending window order (beams clipped to R - 1),
    the first that writes decides (code 2 -> 255, 3 -> 0, 1 -> 200); no
    visit or no writer -> 200.  A constant-200 block (w = 0) writes 200."""
    n, r = s_hit.shape
    sh, st = s_hit.astype(np.int64), s_tail.astype(np.int64)
    out = np.full((n, n_slots), np.nan, np.float32)
    assert (blocks.w[:blocks.n_wide] > painter.NARROW_W).all()
    assert (blocks.w[blocks.n_wide:] <= painter.NARROW_W).all()
    for b in range(blocks.slots.shape[0]):
        lists = _block_lists(blocks, b)
        per = WIDE_ROBOTS if b < blocks.n_wide else ROBOTS
        for r0 in range(0, n, per):
            rows = np.arange(r0, min(r0 + per, n))
            for j, slot in enumerate(blocks.slots[b]):
                if slot < 0:
                    continue
                assert np.isnan(out[r0, slot]), "slot written twice"
                val = np.full(len(rows), np.nan)
                for wp, T in lists[j]:
                    beam = min(int(blocks.rb[b]) + wp, r - 1)
                    h, t = sh[rows, beam], st[rows, beam]
                    x = np.where(T <= h, 255.0, np.where(
                        T == h + 1, 0.0, np.where(T > t, 200.0, np.nan)))
                    val = np.where(np.isnan(val), x, val)
                out[rows, slot] = np.where(np.isnan(val), 200.0, val)
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
    assert tb.blocks is not None and tb.slots is None
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
    """K3 reads the thresholds of every beam that visits a slot, so no
    visit may lie past the last beam (the TPU layout pads the beams to a
    multiple of 128, and an earlier slot-row kernel read up to 64 rows
    past the end of its threshold buffers, an illegal address when that
    buffer ended a mapped segment).  Every visit of the env's layout lies
    within the beams and still paints what the twin paints; a layout whose
    visits pass the tables' last beam is refused."""
    from img_env_tpu_torch.config import EnvConfig
    from img_env_tpu_torch.env.nav_env import NavEnv

    from tests.test_torch_env import small_cfg_dict

    env = NavEnv(EnvConfig.from_dict(small_cfg_dict()), "cpu")
    st = env.statics
    beams = st.view_params.range_total
    slots = painter.PaintSlots.build(st.painter)
    assert ((slots.visits >> 16) < beams).all()
    off, visits = env.tables.painter.slots
    assert torch.equal(off, torch.as_tensor(slots.off))
    assert torch.equal(visits, torch.as_tensor(slots.visits))
    n = 3
    s_hit = torch.as_tensor(rng.integers(0, 40, (n, beams)), dtype=torch.int16)
    s_tail = s_hit + torch.as_tensor(rng.integers(0, 4, (n, beams)),
                                     dtype=torch.int16)
    want = painter.paint(st.painter, env.tables.painter, s_hit, s_tail)
    np.testing.assert_array_equal(
        _emulate_slots(slots, s_hit.numpy(), s_tail.numpy(),
                       st.painter.n_slots), want.numpy())
    short = st.painter._replace(globstep=st.painter.globstep[:beams - 8])
    with pytest.raises(ValueError, match="past the last beam"):
        painter.PaintSlots.build(short)


def _twin_visits(pst):
    """(slot, beam, T) of every visit in the twin's tables: the regions'
    [nb, W, BM] windows and the wide rows over all beams."""
    out = set()
    for reg in pst.regions:
        for b, w, m in zip(*np.nonzero(reg.sstep)):
            out.add((reg.lo + b * 64 + m, int(reg.rbase[b]) + w,
                     int(reg.sstep[b, w, m])))
    for i, r in zip(*np.nonzero(pst.wide_sstep[:len(pst.wide_slots)])):
        out.add((int(pst.wide_slots[i]), r, int(pst.wide_sstep[i, r])))
    return out


@pytest.mark.parametrize("beams", [32, 360])
def test_paint_slots_layout_covers_every_slot_once(beams):
    """K3's layout lists every slot of the painted space once (CSR offsets
    over all P' slots), each slot's visitors in strictly descending beam
    order, no visit past the last beam, and exactly the twin's visits: the
    regions' windows and, at 360 beams, the dense near-sensor rows over
    all beams.  The kernel's slot-order tiles (1024 slots a block, 4 a
    thread) write every slot once."""
    vp = view.ViewParams(*VP._replace(range_total=beams))
    pst = painter.PainterStatics.build(polar.PolarStatics.build(vp,
                                                                n_chunks=8))
    assert (len(pst.wide_slots) > 0) == (beams > 256)
    slots = painter.PaintSlots.build(pst)
    off, visits = slots.off.astype(np.int64), slots.visits.astype(np.int64)
    assert off.shape == (pst.n_slots + 1,) and off[0] == 0
    assert off[-1] == len(visits) and (np.diff(off) >= 0).all()
    beam, T = visits >> 16, visits & 0xFFFF
    assert (beam < beams).all() and (T > 0).all()
    slot = np.repeat(np.arange(pst.n_slots), np.diff(off))
    same = slot[1:] == slot[:-1]
    assert (beam[1:][same] < beam[:-1][same]).all()
    assert set(zip(slot.tolist(), beam.tolist(), T.tolist())) == \
        _twin_visits(pst)
    if beams > 256:
        dense = np.diff(off)[pst.wide_slots]
        assert dense.max() > 256          # the near-sensor rows
    tiles = _tile_slots(pst.n_slots)
    assert np.array_equal(np.sort(tiles), np.arange(pst.n_slots))


def _forced(kind, pst, t, n, rng):
    """Thresholds [n, R] int16: 'no_hit' (the 2**14 sentinel), 'step0'
    (every beam hits at its first step), 'last' (at its last step),
    'mixed' (random hits, every third beam missing), or 'minor_runs' (hits
    at the first step, two beams of three with a minor run to the last
    step: their later visits write nothing, so walks go deep)."""
    r, s = pst.globstep.shape[0], pst.n_steps
    big = torch.full((n, r), 2 ** 14, dtype=torch.int64)
    if kind == "no_hit":
        return big.to(torch.int16), big.to(torch.int16)
    if kind == "mixed":
        s_hit = torch.as_tensor(rng.integers(0, s, (n, r)))
    else:
        s_hit = torch.full((n, r), s - 1 if kind == "last" else 0)
    s_tail = torch.gather(t.nxt[None].expand(n, r, s), 2,
                          s_hit[..., None])[..., 0]
    if kind == "mixed":
        s_hit[:, ::3], s_tail[:, ::3] = 2 ** 14, 2 ** 14
    if kind == "minor_runs":
        s_tail[:, 1::3], s_tail[:, 2::3] = 2 ** 14 - 1, 2 ** 14 - 1
    return s_hit.to(torch.int16), s_tail.to(torch.int16)


@pytest.mark.parametrize("kind", ["no_hit", "step0", "last", "mixed",
                                  "minor_runs"])
def test_paint_slots_decode_forced_thresholds(rng, kind):
    """The slot-order tiles and the dense near-sensor slots (360 beams),
    and K5's 64-slot blocks with their pack of wide slots, decode to the
    twin's output on forced thresholds: no hit, a hit at every beam's
    first step, at its last step, a random mix, and deep walks."""
    vp = view.ViewParams(*VP._replace(range_total=360))
    pst = painter.PainterStatics.build(polar.PolarStatics.build(vp,
                                                                n_chunks=8))
    slots = painter.PaintSlots.build(pst)
    t = painter.make_painter_tables(pst, slots, "cpu")
    s_hit, s_tail = _forced(kind, pst, t, 5, rng)
    want = painter.paint(pst, t, s_hit, s_tail)
    got = _emulate_slots(slots, s_hit.numpy(), s_tail.numpy(), pst.n_slots)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(_emulate_blocks(
        painter.PaintBlocks.build(pst, 360), s_hit.numpy(), s_tail.numpy(),
        pst.n_slots), want.numpy())
    if kind == "no_hit":       # every visited slot is painted 255
        visited = np.diff(slots.off) > 0
        assert (got[:, visited] == 255).all() and (got[:, ~visited] == 200).all()
