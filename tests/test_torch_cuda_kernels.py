"""The CUDA kernels vs their plain-torch twins on the card, at odd small
shapes: robot counts off the warp width, robots on the map edge, robots
stacked on one pose, footprints at the span limit and more robots than
the card holds blocks at once (K1); the fill across scenes and with a
bitmap too large for shared memory (K2); the painter's dense near-sensor
slots on forced thresholds (K3, and K5 on the same); ped counts off the shared-memory tile,
peds on the +-3 m window edge, exact range ties, no ped in any window and
600 in one (K4); the gen-1 block painter with wide slots (K5); and the
scenario sampler on a CUDA generator.  The scene batch: K1 over S = 1, 3
and 16 scenes in one launch, K2 with explicit in-scene ids (a sensor
group's robots), K3 and K5 on a fast-mode grid's tables.  The SFM and
the ORCA crowds of 50-scene batches stepped at once against 50 one-scene
steps, and their device operations.

These need an NVIDIA GPU and nvcc and skip without them.  On the machine
with the card (which has no JAX) run them without the JAX test conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.env import observe, sampler
from img_env_tpu_torch.ops import f32, painter, pedmap, polar, raster, view
from img_env_tpu_torch.ops.footprint import circle_points, rectangle_points

pytestmark = pytest.mark.cuda

RES = 0.05
VP = view.ViewParams(
    hpx=64, wpx=64, resolution=RES, half=1.6,
    angle_begin=-1.570795, angle_end=1.570795,
    min_dist=0.0, max_dist=10.0, range_total=32, use_laser=True,
)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _footprints(n):
    clouds = [circle_points(0, 0, 0.17) if i % 3 else
              rectangle_points(-0.2, 0.2, -0.1, 0.15) for i in range(n)]
    pmax = max(c.shape[0] for c in clouds)
    pts = np.zeros((n, pmax, 2), np.float32)
    msk = np.zeros((n, pmax), bool)
    for i, c in enumerate(clouds):
        pts[i, : c.shape[0]] = c
        msk[i, : c.shape[0]] = True
    return pts, msk


def _scene(n, seed, dev):
    rng = np.random.default_rng(seed)
    poses = np.stack([rng.uniform(0.2, 7.3, n), rng.uniform(0.2, 7.3, n),
                      rng.uniform(-3.14, 3.14, n)], -1).astype(np.float32)
    poses[-1, :2] = [0.02, 7.45]                   # straddles the map edge
    if n >= 3:
        poses[1, :2] = poses[0, :2] + 0.05         # overlap
    static = np.full((150, 150), 255, np.uint8)
    static[40:60, 40:44] = 0
    pts, msk = _footprints(n)
    t = lambda a: torch.as_tensor(a, device=dev)
    return t(poses), t(static), t(pts), t(msk)


@pytest.mark.parametrize("n", [1, 37, 70])
def test_raster_kernel_matches_twin(dev, n):
    poses, static, pts, msk = _scene(n, n, dev)
    cells = raster.world_to_cell(raster.transform_points(poses, pts), RES)
    got = raster.robot_maps_kernel(cells, msk, *static.shape)
    want = raster.robot_maps_twin(cells, msk, *static.shape)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["stacked", "map_edges", "span_limit",
                                  "many_robots"])
def test_raster_kernel_edge_cases(dev, case):
    """Every robot on one pose (count N, id sums up to N (N + 1) / 2);
    footprints straddling each map edge and corner; circle footprints
    spanning RASTER_MAX_SPAN cells (more points than a block holds in
    registers); 1500 robots, more than the card holds blocks at once."""
    n = 1500 if case == "many_robots" else 37
    poses, static, pts, msk = _scene(n, 11, dev)
    h, w = static.shape
    if case == "stacked":
        poses = poses[:1].expand_as(poses)
    elif case == "map_edges":
        top_x, top_y = (h - 1) * RES, (w - 1) * RES
        poses = poses.clone()
        poses[0:6, 0], poses[6:12, 0] = 0.0, top_x
        poses[12:18, 1], poses[18:24, 1] = 0.0, top_y
        poses[24:28, :2] = torch.tensor(
            [[0.0, 0.0], [top_x, 0.0], [0.0, top_y], [top_x, top_y]],
            device=dev)
    elif case == "span_limit":
        big = circle_points(0.0, 0.0,
                            (raster.RASTER_MAX_SPAN - 2.5) * RES / 2)
        assert raster.check_footprint_span(big[None], RES) == \
            raster.RASTER_MAX_SPAN
        pts = torch.as_tensor(big, device=dev).expand(n, -1, -1)
        msk = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    cells = raster.world_to_cell(raster.transform_points(poses, pts), RES)
    got = raster.robot_maps_kernel(cells, msk, h, w)
    want = raster.robot_maps_twin(cells, msk, h, w)
    assert torch.equal(got, want)
    if case == "stacked":
        assert int((got & 0xFFF).max()) == n
        assert int((got >> 12).max()) == n * (n + 1) // 2


@pytest.mark.parametrize("n", [1, 37, 70])
def test_fill_and_paint_kernels_match_twins(dev, n):
    poses, static, pts, msk = _scene(n, 100 + n, dev)
    ps = polar.PolarStatics.build(VP, n_chunks=8)
    pst = painter.PainterStatics.build(ps)
    tp = polar.make_tables(ps, np.zeros((n, ps.n_slots), bool), dev)
    tt = painter.make_painter_tables(pst, painter.PaintSlots.build(pst), dev)
    e = torch.zeros((0, 1, 2), device=dev)
    eb = torch.zeros((0, 1), dtype=torch.bool, device=dev)
    layers = raster.build_layers(static, RES, poses, pts, msk,
                                 torch.zeros((0, 3), device=dev),
                                 e, eb, e, eb, e, eb)
    cos, sin = torch.cos(poses[:, 2]), torch.sin(poses[:, 2])
    args = (layers.packed, cos, sin, poses[:, 0].contiguous(),
            poses[:, 1].contiguous(), tp.pix_x, tp.pix_y, ps.n_fill_slots,
            RES)
    occ = polar.fill_sorted_kernel(*args)
    assert torch.equal(occ, polar.fill_sorted_twin(*args))
    _, _, aux = polar.raycast_batched(ps, tp, occ)
    s_hit, s_tail = painter.hit_steps(pst, tt, *aux)
    got = painter.paint_slots_kernel(tt, s_hit, s_tail, pst.n_slots)
    assert torch.equal(got, painter.paint_sorted(pst, tt, s_hit, s_tail))


@pytest.mark.parametrize("s,n", [(1, 37), (3, 5), (16, 12)])
def test_raster_kernel_scene_axis(dev, s, n):
    """S scenes in one launch, robots overlapping within and across scenes
    (ids are in-scene), footprint masks shared by the scenes."""
    scenes = [_scene(n, 300 + k, dev) for k in range(s)]
    static, pts, msk = scenes[0][1:]
    poses = torch.stack([x[0] for x in scenes])
    poses[1:, 0] = poses[0, 0]                    # the same cell in scenes
    cells = raster.world_to_cell(raster.transform_points(poses, pts), RES)
    got = raster.robot_maps_kernel(cells, msk, *static.shape)
    want = raster.robot_maps_twin(cells, msk, *static.shape)
    assert got.shape == (s,) + tuple(static.shape)
    assert torch.equal(got, want)
    assert int((got & 0xFFF).max()) >= 2


@pytest.mark.parametrize("scenes", [1, 4])
def test_fill_kernel_with_rids(dev, scenes):
    """A sensor group's robots, in-scene ids 1, 3, 4 of 4 (robot 2 stands
    on robot 0; ids from group positions would change the fill)."""
    ids = np.asarray([1, 3, 4], np.int32)
    packs, poses = [], []
    for k in range(scenes):
        pose, static, pts, msk = _scene(4, 400 + k, dev)
        pose[1, :2] = pose[0, :2] + 0.04
        e = torch.zeros((0, 1, 2), device=dev)
        eb = torch.zeros((0, 1), dtype=torch.bool, device=dev)
        packs.append(raster.build_layers(
            static, RES, pose, pts, msk, torch.zeros((0, 3), device=dev),
            e, eb, e, eb, e, eb).packed)
        poses.append(pose[torch.as_tensor(ids - 1, device=dev).long()])
    packed, poses = torch.stack(packs), torch.cat(poses)
    ps = polar.PolarStatics.build(VP, n_chunks=8)
    tp = polar.make_tables(ps, np.zeros((3, ps.n_slots), bool), dev)
    rids = torch.as_tensor(np.tile(ids, scenes), device=dev)
    sin, cos = f32.sin_cos(poses[:, 2])
    args = (packed, cos, sin, poses[:, 0].contiguous(),
            poses[:, 1].contiguous(), tp.pix_x, tp.pix_y, ps.n_fill_slots,
            RES, 3)
    got = polar.fill_sorted_kernel(*args, rids=rids)
    want = polar.fill_sorted_twin(*args, rids=rids)
    assert torch.equal(got, want) and bool(want.any())
    assert not torch.equal(got, polar.fill_sorted_kernel(*args))


@pytest.mark.parametrize("scale", [2, 3])
def test_paint_kernel_on_fast_tables(dev, scale):
    """K3 and K5 (and K2 before them) on the fast grid: the view coarsened
    by ``scale``, as sensor_mode='fast' builds it."""
    n = 37
    poses, static, pts, msk = _scene(n, 500 + scale, dev)
    vp = VP._replace(hpx=VP.hpx // scale, wpx=VP.wpx // scale,
                     resolution=RES * scale)
    ps = polar.PolarStatics.build(vp)
    pst = painter.PainterStatics.build(ps)
    tp = polar.make_tables(ps, np.zeros((n, ps.n_slots), bool), dev)
    tt = painter.make_painter_tables(pst, painter.PaintSlots.build(pst), dev)
    e = torch.zeros((0, 1, 2), device=dev)
    eb = torch.zeros((0, 1), dtype=torch.bool, device=dev)
    layers = raster.build_layers(static, RES, poses, pts, msk,
                                 torch.zeros((0, 3), device=dev),
                                 e, eb, e, eb, e, eb)
    occ = polar.fill_sorted(ps, tp, layers.packed, poses, RES)
    sin, cos = f32.sin_cos(poses[:, 2])
    assert torch.equal(occ, polar.fill_sorted_twin(
        layers.packed, cos, sin, poses[:, 0], poses[:, 1], tp.pix_x,
        tp.pix_y, ps.n_fill_slots, RES))
    _, _, aux = polar.raycast_batched(ps, tp, occ)
    s_hit, s_tail = painter.hit_steps(pst, tt, *aux)
    got = painter.paint_slots_kernel(tt, s_hit, s_tail, pst.n_slots)
    want = painter.paint_sorted(pst, tt, s_hit, s_tail)
    assert torch.equal(got, want)
    tb = painter.make_painter_tables(pst, painter.PaintBlocks.build(
        pst, vp.range_total), dev)
    assert torch.equal(painter.paint_blocks_kernel(tb, s_hit, s_tail,
                                                   pst.n_slots), want)


@pytest.mark.parametrize("n,h,w,nps", [(6, 150, 150, 3), (5, 1700, 1100, 5),
                                       (8, 1700, 1100, 2)])
def test_fill_kernel_scenes_and_large_maps(dev, n, h, w, nps):
    """Random packed maps (static cells, overlaps, single-robot cells of
    every id) stacked per scene, robot i reading scene i // nps; at
    1700 x 1100 the bitmap (1700 x 36 words, 245 KB) exceeds a block's
    shared memory and the fill reads it through L1."""
    rng = np.random.default_rng(h + nps)
    scenes = n // nps
    u = rng.random((scenes, h, w))
    v = np.where(u < 0.05, 1, 0)
    v = np.where((u >= 0.05) & (u < 0.08),
                 (rng.integers(2, 4, u.shape) << 1)
                 | (rng.integers(1, 4096, u.shape) << 3), v)
    v = np.where((u >= 0.08) & (u < 0.2),
                 2 | (rng.integers(1, nps + 1, u.shape) << 3), v)
    packed = torch.as_tensor(v.astype(np.int32), device=dev)
    ps = polar.PolarStatics.build(VP, n_chunks=8)
    tp = polar.make_tables(ps, np.zeros((n, ps.n_slots), bool), dev)
    poses = torch.as_tensor(np.column_stack([
        rng.uniform(0, h * RES, n), rng.uniform(0, w * RES, n),
        rng.uniform(-3.1, 3.1, n)]).astype(np.float32), device=dev)
    poses[0, :2] = 0.0                                 # on the map corner
    sin, cos = f32.sin_cos(poses[:, 2])
    args = (packed, cos, sin, poses[:, 0].contiguous(),
            poses[:, 1].contiguous(), tp.pix_x, tp.pix_y, ps.n_fill_slots,
            RES, nps)
    got = polar.fill_sorted_kernel(*args)
    want = polar.fill_sorted_twin(*args)
    assert torch.equal(got, want) and bool(want.any())


@pytest.mark.parametrize("kind", ["no_hit", "step0", "last", "mixed",
                                  "minor_runs"])
def test_paint_kernel_forced_thresholds(dev, kind):
    """K3 and K5 at 360 beams (dense near-sensor slots, a pack of wide
    slots) on forced thresholds: no hit, a hit at every beam's first step,
    at its last step, a mix, and hits at step 0 with minor runs to the last
    step on two beams of three (top visits that write nothing, so the
    warps walk the slots' lists)."""
    vp = VP._replace(range_total=360)
    pst = painter.PainterStatics.build(polar.PolarStatics.build(vp,
                                                                n_chunks=8))
    tt = painter.make_painter_tables(pst, painter.PaintSlots.build(pst), dev)
    tb = painter.make_painter_tables(pst, painter.PaintBlocks.build(pst, 360),
                                     dev)
    n, r, s = 37, 360, pst.n_steps
    rng = np.random.default_rng(7)
    if kind == "no_hit":
        s_hit = torch.full((n, r), 2 ** 14, device=dev)
    elif kind == "mixed":
        s_hit = torch.as_tensor(rng.integers(0, s, (n, r)), device=dev)
    else:
        s_hit = torch.full((n, r), s - 1 if kind == "last" else 0,
                           device=dev)
    s_tail = torch.gather(tt.nxt[None].expand(n, r, s), 2,
                          s_hit.clamp(0, s - 1)[..., None])[..., 0]
    s_tail = torch.where(s_hit == 2 ** 14, s_hit, s_tail)
    if kind == "mixed":
        s_hit[:, ::3], s_tail[:, ::3] = 2 ** 14, 2 ** 14
    if kind == "minor_runs":
        s_tail[:, 1::3], s_tail[:, 2::3] = 2 ** 14 - 1, 2 ** 14 - 1
    s_hit, s_tail = s_hit.to(torch.int16), s_tail.to(torch.int16)
    want = painter.paint_sorted(pst, tt, s_hit, s_tail)
    got = painter.paint_slots_kernel(tt, s_hit, s_tail, pst.n_slots)
    assert torch.equal(got, want)
    got = painter.paint_blocks_kernel(tb, s_hit, s_tail, pst.n_slots)
    assert torch.equal(got, want)


def _peds(n, m, seed, dev):
    rng = np.random.default_rng(seed)
    poses = np.column_stack([rng.uniform(1, 9, (n, 2)),
                             rng.uniform(-np.pi, np.pi, n)]).astype(np.float32)
    pos = rng.uniform(0, 10, (m, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (m, 2)).astype(np.float32)
    poses[0, 2] = 0.0
    if m >= 8:
        pos[1:4] = poses[0, :2] + [1.0, 0.5]       # three-way range tie
        pos[4] = poses[0, :2] + [3.0, -1.0]        # on the window edge
        pos[5] = poses[0, :2] + [-3.0, 3.0]        # on a corner
        pos[6] = poses[0, :2]                      # range 0
        pos[7] = poses[0, :2] + [0.3, 0.0]
    t = lambda a: torch.as_tensor(a, device=dev)
    return observe.peds_in_base(t(poses), t(pos), t(vel))


@pytest.mark.parametrize("n,m", [(1, 1), (33, 8), (37, 257), (70, 600)])
def test_pedmap_kernel_matches_twin(dev, n, m):
    """M within one 512-ped tile (1, 8, 257) and over two (600), N off
    the warp width."""
    base = _peds(n, m, n + m, dev)
    got = pedmap.ped_map_kernel(*base, 0.125, 0.3, 48)
    want = pedmap.ped_map_twin(*base, 0.125, 0.3, 48)
    assert torch.equal(got, want)
    assert bool(got[:, 0].any())


@pytest.mark.parametrize("case", ["all_out", "600_in_one_window", "n1",
                                  "n257"])
def test_pedmap_kernel_edge_cases(dev, case):
    """No ped in any window; all 600 peds inside robot 0's window (many
    compacted peds and many atomics per pixel); N = 1 and N = 257."""
    n, m = {"n1": (1, 40), "n257": (257, 40)}.get(case, (5, 600))
    base = list(_peds(n, m, 17, dev))
    if case == "all_out":
        base[0] = base[0] + 100.0
    elif case == "600_in_one_window":
        rng = np.random.default_rng(5)
        xy = torch.as_tensor(rng.uniform(-3.0, 3.0, (2, m)).astype(
            np.float32), device=dev)
        base[0][0], base[1][0] = xy[0], xy[1]
    got = pedmap.ped_map_kernel(*base, 0.125, 0.3, 48)
    want = pedmap.ped_map_twin(*base, 0.125, 0.3, 48)
    assert torch.equal(got, want)
    assert bool(got[:, 0].any()) == (case != "all_out")


def test_sampler_follows_a_cuda_generator(dev):
    """Without a device argument, the draws and the scenario lie on the
    generator's device; with one, on that device."""
    cfg = EnvConfig.from_dict({
        "robot": dict(total=3, shape=["circle"], size=[[0.0, 0.0, 0.17]],
                      begin_poses_type=["range"],
                      begin_poses=[[1.5, 8.5, 1.5, 8.5]],
                      target_poses_type=["range"],
                      target_poses=[[1.5, 8.5, 1.5, 8.5]]),
        "object": dict(total=2, shape=["circle"], size_range=[[0.2, 0.3]],
                       poses_type=["range"], poses=[[2.0, 8.0, 2.0, 8.0]]),
        "ped_sim": {"total": 0, "type": ""},
        "global_map": {"map_file": "room_10.png", "resolution": 0.1}})
    spec = sampler.SamplerSpec.from_config(cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    assert all(x.is_cuda for x in sampler.draw(spec, g))
    for fn in (sampler.sample_scenario, sampler.sample_scenario_retry):
        s = fn(spec, g)
        assert all(x.is_cuda for x in s if isinstance(x, torch.Tensor))
    s = sampler.sample_scenario_retry(spec, g, dev)
    assert s.init_poses.is_cuda


def test_pedmap_kernel_other_sizes(dev):
    """A 64 x 64 map (the kernel's largest) and a 20 x 20 one."""
    base = _peds(9, 50, 3, dev)
    for hs in (20, 64):
        got = pedmap.ped_map_kernel(*base, 6.0 / hs, 0.25, hs)
        want = pedmap.ped_map_twin(*base, 6.0 / hs, 0.25, hs)
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        pedmap.ped_map_kernel(*base, 6.0 / 65, 0.25, 65)


@pytest.mark.parametrize("n,beams", [(1, 32), (37, 32), (70, 360),
                                     (201, 360)])
def test_paint_block_kernel_matches_twin(dev, n, beams):
    """N = 1, N off the 32-robot chunks, and N past 200 with a pack of
    wide slots (their blocks take 4 robots at a time)."""
    vp = VP._replace(range_total=beams)
    ps = polar.PolarStatics.build(vp, n_chunks=8)
    pst = painter.PainterStatics.build(ps)
    tt = painter.make_painter_tables(
        pst, painter.PaintBlocks.build(pst, beams), dev)
    rng = np.random.default_rng(n)
    s_hit = torch.as_tensor(rng.integers(0, 60, (n, beams)),
                            dtype=torch.int16, device=dev)
    s_hit[:, ::3] = 2 ** 14
    s_tail = torch.where(s_hit == 2 ** 14, s_hit, s_hit + torch.as_tensor(
        rng.integers(1, 4, (n, beams)), dtype=torch.int16, device=dev))
    got = painter.paint_blocks_kernel(tt, s_hit, s_tail, pst.n_slots)
    assert torch.equal(got, painter.paint_sorted(pst, tt, s_hit, s_tail))
    assert painter.paint(pst, tt, s_hit, s_tail).equal(got)


def test_span_holds_the_kernel_launch(dev):
    """The host spans' clock is the trace's: a span (``utils.trace``,
    ``time.time_ns``) around one K1 launch under torch.profiler with
    device activity only holds the host time of the runtime call whose
    correlation id the raster kernel's device event carries."""
    from img_env_tpu_torch.utils import trace

    poses, static, pts, msk = _scene(37, 37, dev)
    cells = raster.world_to_cell(raster.transform_points(poses, pts), RES)
    raster.robot_maps_kernel(cells, msk, *static.shape)     # built, loaded
    torch.cuda.synchronize()
    trace.enable()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            with trace.span("k1"):
                raster.robot_maps_kernel(cells, msk, *static.shape)
            torch.cuda.synchronize()
        spans, _ = trace.drain()
    finally:
        trace.disable()
    [(_, _, lo, hi)] = spans
    events = list(prof.profiler.kineto_results.events())
    on_card = lambda e: e.device_type() == torch.autograd.DeviceType.CUDA
    [kernel] = [e for e in events
                if on_card(e) and "raster_robots_kernel" in e.name()]
    [call] = [e for e in events if not on_card(e)
              and e.name().startswith("cu")
              and e.correlation_id() == kernel.correlation_id()]
    assert lo <= call.start_ns()
    assert call.start_ns() + call.duration_ns() <= hi
    assert lo <= kernel.start_ns()


def test_batched_crowd_step_on_the_card(dev):
    """The crowd of a 50-scene stage-5 batch (5 SFM leg peds, 1 robot
    mirror and 10 obstacles a scene), stepped at once, equals the 50
    scenes stepped one at a time (S=1) bit for bit, after five steps that
    spread the scenes' queues and gaits; one batched step issues at most
    1,000 device operations, as many as one scene's step."""
    import json
    import os

    import img_env_tpu_torch
    from img_env_tpu_torch.core.state import map_tree, stack_trees
    from img_env_tpu_torch.env.nav_env import NavEnv

    path = os.path.join(os.path.dirname(img_env_tpu_torch.__file__),
                        "artifacts", "stage5_policy_env.json")
    with open(path) as f:
        core = NavEnv(EnvConfig.from_dict(json.load(f)), dev, seed=3)
    s, n = 50, core.cfg.robot.total
    states = stack_trees([core.reset_state_fn() for _ in range(s)])
    src = torch.zeros((s, n, 2), device=dev)
    rad = torch.zeros((s, n), device=dev)

    def crowd(st):
        k = st.step.shape[0]
        peds, aux = core._crowd_step(st, src[:k], rad[:k])
        return st._replace(peds=peds, crowd_aux=aux)

    def leaves(st):
        out = []
        map_tree(out.append, st.peds)
        map_tree(out.append, st.crowd_aux)
        return out

    for _ in range(5):
        states = crowd(states)
    got = leaves(crowd(states))
    for k in range(s):
        want = leaves(crowd(map_tree(lambda x: x[k:k + 1], states)))
        for i, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g[k:k + 1], w), (k, i)

    def ops(st):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            crowd(st)
            torch.cuda.synchronize()
        return sum(e.device_type() == torch.autograd.DeviceType.CUDA
                   for e in prof.profiler.kineto_results.events())

    batched = ops(states)
    assert 0 < batched <= 1000
    assert batched == ops(map_tree(lambda x: x[:1], states))


def test_batched_orca_crowd_step_on_the_card(dev):
    """The ORCA crowd of a 50-scene ERVO batch (8 leg peds, 1 robot
    mirror and its split segments a scene), solved at once, equals the 50
    scenes solved one at a time (S=1) bit for bit, after three steps that
    spread the scenes and then with every robot's beep answered (the
    evacuation term); one batched step issues at most 2,000 device
    operations, about one scene's."""
    import json
    import os

    import img_env_tpu_torch
    from img_env_tpu_torch.core.state import map_tree, stack_trees
    from img_env_tpu_torch.crowd import common
    from img_env_tpu_torch.env.nav_env import NavEnv

    path = os.path.join(os.path.dirname(img_env_tpu_torch.__file__),
                        "artifacts", "ervo_policy_env.json")
    with open(path) as f:
        core = NavEnv(EnvConfig.from_dict(json.load(f)), dev, seed=3)
    s, n = 50, core.cfg.robot.total
    states = stack_trees([core.reset_state_fn() for _ in range(s)])
    assert states.obstacles.segs is not None
    quiet = (torch.zeros((s, n, 2), device=dev),
             torch.zeros((s, n), device=dev))
    src, rad, beeps = common.sample_beeps(
        states.robots.pose.reshape(s * n, 3), torch.ones(s * n, device=dev),
        float(core.cfg.beep_r), float(core.cfg.ped_ca_p),
        u=torch.zeros(s * n, device=dev))
    assert int(beeps.sum()) == s * n
    loud = (src.reshape(s, n, 2), rad.reshape(s, n))

    def crowd(st, beep):
        k = st.step.shape[0]
        peds, aux = core._crowd_step(st, beep[0][:k], beep[1][:k])
        return st._replace(peds=peds, crowd_aux=aux)

    def leaves(st):
        out = []
        map_tree(out.append, st.peds)
        map_tree(out.append, st.crowd_aux)
        return out

    for _ in range(3):
        states = crowd(states, quiet)
    for beep in (quiet, loud):
        got = leaves(crowd(states, beep))
        for k in range(s):
            one = (beep[0][k:k + 1], beep[1][k:k + 1])
            want = leaves(crowd(map_tree(lambda x: x[k:k + 1], states), one))
            for i, (g, w) in enumerate(zip(got, want)):
                assert torch.equal(g[k:k + 1], w), (k, i)
    moved = crowd(states, loud).peds.pos
    assert not torch.equal(moved, crowd(states, quiet).peds.pos)

    def ops(st):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            crowd(st, loud)
            torch.cuda.synchronize()
        return sum(e.device_type() == torch.autograd.DeviceType.CUDA
                   for e in prof.profiler.kineto_results.events())

    batched = ops(states)
    assert 0 < batched <= 2000, batched
