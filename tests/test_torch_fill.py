"""FOV fill (kernel K2's twin) of the torch port vs the JAX package.

The twin must equal the Pallas fill kernel run in interpret mode (as
tests/test_pallas_fill.py runs it), jitted in float32 like the production
program, on the same packed map and f32 poses; and it must stay within the
JAX package's own bound of the float64 gather fill through the gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img_env_tpu.ops import polar as jpolar
from img_env_tpu.ops.pallas_fill import fill_sorted_pallas
from img_env_tpu_torch.ops import polar, view

from tests.test_pallas_fill import VP
from tests.test_raster import RES, _layers_from_scene, _random_scene


@pytest.fixture(scope="module")
def statics():
    ps_j = jpolar.PolarStatics.build(VP, n_chunks=8)
    ps_t = polar.PolarStatics.build(view.ViewParams(*VP), n_chunks=8)
    own = np.zeros((1, ps_t.n_slots), bool)
    return ps_j, ps_t, polar.make_tables(ps_t, own, "cpu")


def _scene(rng):
    static, obs, peds, robots = _random_scene(rng, n_rob=5, n_ped=2,
                                              n_obs=3)
    layers = _layers_from_scene(static, obs, peds, robots)
    poses = np.stack([p for p, _ in robots]).astype(np.float32)
    # one robot near the map edge so out-of-map slots occur
    poses[-1, :2] = [0.3, 9.7]
    return np.array(layers.packed), poses


@pytest.mark.parametrize("trial", range(3))
def test_fill_twin_matches_pallas_kernel(rng, statics, trial):
    ps_j, ps_t, t = statics
    packed, poses = _scene(rng)
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(lambda pm, p: fill_sorted_pallas(
            ps_j, pm, RES, p, interpret=True))(
                jnp.asarray(packed), jnp.asarray(poses)))
    got = polar.fill_sorted(ps_t, t, torch.as_tensor(packed),
                            torch.as_tensor(poses), RES).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got[:, ps_t.n_fill_slots:].any()


@pytest.mark.parametrize("scenes", [1, 2])
def test_fill_twin_with_rids_matches_pallas_kernel(rng, statics, scenes):
    """Explicit in-scene ids, as a sensor group passes them: robots 0, 2
    and 4 of each scene's five, ids 1, 3 and 5 (group-local positions would
    give 1, 2 and 3, and robot 2 would then exclude robot 1's cells), each
    scene read by its robots; against the Pallas fill in interpret mode
    (vmapped over scenes) and the gather fill, both with the same rids."""
    ps_j, ps_t, t = statics
    packs, poses = zip(*(_scene(rng) for _ in range(scenes)))
    packed, poses = np.stack(packs), np.stack(poses)[:, ::2]   # [S, 3, 3]
    rids = np.asarray([1, 3, 5], np.int32)
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(jax.vmap(
            lambda pm, p: fill_sorted_pallas(ps_j, pm, RES, p,
                                             rids=jnp.asarray(rids),
                                             interpret=True)))(
            jnp.asarray(packed), jnp.asarray(poses)))
        gather = np.asarray(jax.jit(jax.vmap(
            lambda pm, p: jpolar.fill_sorted(ps_j, pm, RES, p,
                                             rids=jnp.asarray(rids))))(
            jnp.asarray(packed), jnp.asarray(poses)))
    got = polar.fill_sorted(
        ps_t, t, torch.as_tensor(packed),
        torch.as_tensor(poses.reshape(-1, 3)), RES,
        torch.as_tensor(np.tile(rids, scenes))).numpy()
    np.testing.assert_array_equal(got, want.reshape(got.shape))
    np.testing.assert_array_equal(
        got, (gather & ps_j.gates_sorted).reshape(got.shape))
    default = polar.fill_sorted(ps_t, t, torch.as_tensor(packed),
                                torch.as_tensor(poses.reshape(-1, 3)),
                                RES).numpy()
    assert (default != got).any()


def test_fill_twin_close_to_f64_gather(rng, statics):
    """x64 CPU reference vs the f32 fill: only boundary-rounding slips, the
    JAX package's own bound (tests/test_pallas_fill.py)."""
    ps_j, ps_t, t = statics
    packed, poses = _scene(rng)
    want = (np.asarray(jpolar.fill_sorted(ps_j, jnp.asarray(packed), RES,
                                          jnp.asarray(poses, jnp.float64)))
            & ps_j.gates_sorted[None])
    got = polar.fill_sorted(ps_t, t, torch.as_tensor(packed),
                            torch.as_tensor(poses), RES).numpy()
    mism = (got != want).mean()
    assert mism < 2e-3, f"mismatch fraction {mism}"


def test_fill_self_exclusion_and_scenes(statics):
    """Each robot sees the others, never itself; with a scene batch robot i
    reads map i // nps under in-scene id i % nps + 1."""
    ps_j, ps_t, t = statics
    h = w = 220
    packed = np.zeros((2, h, w), np.int32)
    for s in range(2):
        for rid, (m, n) in enumerate([(60, 60), (61, 62)], start=1):
            packed[s, m, n] = (1 << 1) | (rid << 3)
    poses = torch.tensor([[60 * RES, 60 * RES, 0.0],
                          [61 * RES, 62 * RES, 1.0]] * 2)
    cos, sin = torch.cos(poses[:, 2]), torch.sin(poses[:, 2])
    occ = polar.fill_sorted_twin(
        torch.as_tensor(packed), cos, sin, poses[:, 0].contiguous(),
        poses[:, 1].contiguous(), t.pix_x, t.pix_y, ps_t.n_fill_slots, RES,
        nps=2)
    single = polar.fill_sorted_twin(
        torch.as_tensor(packed[0]), cos[:2], sin[:2], poses[:2, 0],
        poses[:2, 1], t.pix_x, t.pix_y, ps_t.n_fill_slots, RES)
    np.testing.assert_array_equal(occ[:2].numpy(), single.numpy())
    np.testing.assert_array_equal(occ[2:].numpy(), single.numpy())
    # robot 1 sees robot 2's cell and not its own, and vice versa
    for i, (own, other) in enumerate([((60, 60), (61, 62)),
                                      ((61, 62), (60, 60))]):
        c, s = float(cos[i]), float(sin[i])
        bx, by = t.pix_x.numpy(), t.pix_y.numpy()
        wx = c * bx - s * by + float(poses[i, 0])
        wy = s * bx + c * by + float(poses[i, 1])
        cm, cn = np.round(wx / RES), np.round(wy / RES)
        hit = lambda cell: (cm == cell[0]) & (cn == cell[1])
        row = single[i].numpy()
        assert not row[hit(own)].any()
        if hit(other).any():
            assert row[hit(other) & ps_t.gates_sorted].all()


def _own_cell(v, rid1):
    """Cells that robot ``rid1`` alone covers: no static bit, one robot,
    id ``rid1`` (csrc/fill.cu's own())."""
    return ((v & 1) == 0) & (((v >> 1) & 3) == 1) & (((v >> 3) & 0xFFF) == rid1)


def _random_packed(rng, scenes, h, w, nps):
    """Random id-packed maps [S, h, w]: static cells, overlaps (count 2-3,
    an id sum in the id field), and single-robot cells of every in-scene
    id, some around each robot's own pose."""
    v = np.zeros((scenes, h, w), np.int64)
    u = rng.random((scenes, h, w))
    v[u < 0.05] |= 1                                   # static
    over = (u >= 0.05) & (u < 0.08)
    v[over] |= rng.integers(2, 4, over.sum()) << 1     # 2-3 robots
    v[over] |= rng.integers(1, 4096, over.sum()) << 3
    single = (u >= 0.08) & (u < 0.15)
    v[single] |= (1 << 1) | (rng.integers(1, nps + 1, single.sum()) << 3)
    both = (u >= 0.15) & (u < 0.16)                    # static + a robot
    v[both] |= 1 | (1 << 1) | (rng.integers(1, nps + 1, both.sum()) << 3)
    return v.astype(np.int32)


@pytest.mark.parametrize("nps", [6, 3, 2])
def test_fill_bitmap_prepass_and_identity(rng, statics, nps):
    """K2's path: the pre-pass bitmap twin holds anyocc of every cell (the
    row padded to whole words), the identity decode = anyocc & ~own holds
    for every value and robot id, and the fill through the bitmap -- a bit
    test, then the packed map only where the bit is set -- equals the
    twin, robot i reading scene i // nps (nps = N and nps < N).  Rows
    are padded to 4 words (16 bytes), the padding bits 0."""
    from img_env_tpu_torch.ops.raster import div_const, round_half_away

    _, ps_t, t = statics
    n, h, w = 6, 90, 75                   # w is not a multiple of 32
    scenes = n // nps
    packed = _random_packed(rng, scenes, h, w, nps)
    poses = np.column_stack([rng.uniform(0.2, 4.3, n), rng.uniform(0.2, 3.6, n),
                             rng.uniform(-3.1, 3.1, n)]).astype(np.float32)
    poses[0, :2] = [0.05, 3.7]            # views leave the map
    for i in range(n):                    # the robot's own cells, in view
        m0, n0 = (np.round(poses[i, :2] / RES).astype(int)
                  + [[0, 0], [1, 0], [0, 1], [2, 2]]).T
        ok = (m0 < h) & (n0 < w)
        packed[i // nps, m0[ok], n0[ok]] = (1 << 1) | ((i % nps + 1) << 3)
    pm = torch.as_tensor(packed)

    bits = polar.occupancy_bits_twin(pm)
    words = polar.bitmap_words(w)
    assert words == 4 and bits.shape == (scenes, h, words)
    assert bits.dtype == torch.int32
    col = torch.arange(words * 32)
    bit = (bits[..., col // 32] >> (col % 32)) & 1
    anyocc = ((pm & 1) | ((pm >> 1) & 3)) != 0
    assert torch.equal(bit[..., :w].bool(), anyocc)
    assert not bit[..., w:].any()
    for rid in range(1, nps + 1):
        assert torch.equal(polar.decode_packed(pm, rid),
                           anyocc & ~_own_cell(pm, rid))

    p = torch.as_tensor(poses)
    cos, sin = torch.cos(p[:, 2]), torch.sin(p[:, 2])
    nf = ps_t.n_fill_slots
    want = polar.fill_sorted_twin(pm, cos, sin, p[:, 0].contiguous(),
                                  p[:, 1].contiguous(), t.pix_x, t.pix_y,
                                  nf, RES, nps=nps)
    bx, by = t.pix_x[:nf][None], t.pix_y[:nf][None]
    wx = cos[:, None] * bx - sin[:, None] * by + p[:, 0:1]
    wy = sin[:, None] * bx + cos[:, None] * by + p[:, 1:2]
    cm = round_half_away(div_const(wx, RES)).to(torch.int64)
    cn = round_half_away(div_const(wy, RES)).to(torch.int64)
    inside = (cm >= 0) & (cm < h) & (cn >= 0) & (cn < w)
    cm, cn = cm.clamp(0, h - 1), cn.clamp(0, w - 1)
    scene = (torch.arange(n) // nps)[:, None]
    set_ = ((bits[scene, cm, cn // 32] >> (cn % 32)) & 1).bool()
    rid = (torch.arange(n) % nps + 1)[:, None]
    own = _own_cell(pm[scene, cm, cn], rid)
    got = inside & set_ & ~own
    assert torch.equal(got, want[:, :nf]) and not want[:, nf:].any()
    assert got.any() and (set_ & own & inside).any()   # own cells seen
