"""Host-side builders of the torch port vs the JAX package's builders.

The port carries numpy copies of the statics builders (it never imports
``img_env_tpu``); these tests hold every table array-equal to the JAX
package's, so both packages run on identical geometry by construction.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.env import maps as jmaps
from img_env_tpu.env import nav_env as jnav
from img_env_tpu.ops import painter as jpainter
from img_env_tpu.ops import pallas_paint_t as jpaint_t
from img_env_tpu.ops import polar as jpolar
from img_env_tpu.ops import resize as jresize
from img_env_tpu.ops import view as jview
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.env import maps
from img_env_tpu_torch.env import nav_env
from img_env_tpu_torch.ops import footprint, painter, polar, resize, view

from tests.test_torch_env import small_cfg_dict

MAP_DIR = os.path.join(os.path.dirname(jmaps.__file__), "..", "maps")
PNGS = sorted(os.path.basename(p)
              for p in glob.glob(os.path.join(MAP_DIR, "*.png")))

VP = jview.ViewParams(
    hpx=64, wpx=64, resolution=0.05, half=1.6,
    angle_begin=-1.570795, angle_end=1.570795,
    min_dist=0.0, max_dist=10.0, range_total=32, use_laser=True,
)


def _assert_tree_equal(a, b, path="root"):
    """Array-equal over nested NamedTuples / tuples / arrays / scalars; a
    port NamedTuple ``b`` may leave out fields of the JAX one ``a``."""
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        assert type(a).__name__ == type(b).__name__, path
        assert set(b._fields) <= set(a._fields), path
        for f in b._fields:
            _assert_tree_equal(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif a is None or isinstance(a, (int, float, bool, str)):
        assert a == b, path
    else:
        x, y = np.asarray(a), np.asarray(b)
        if str(x.dtype) == "bfloat16":      # the JAX 2^-k incidence weights
            x = x.astype(np.float32)        # (exact in both dtypes)
        assert x.dtype == y.dtype, (path, x.dtype, y.dtype)
        assert x.shape == y.shape, (path, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=path)


@pytest.mark.parametrize("png", PNGS)
@pytest.mark.parametrize("view_res", [0.015, 0.05])
def test_map_loader_matches_cv2(png, view_res):
    cfg_j = JaxEnvConfig.from_dict({
        "global_map": {"map_file": png, "resolution": 0.1},
        "view_map": {"resolution": view_res}})
    cfg_t = EnvConfig.from_dict({
        "global_map": {"map_file": png, "resolution": 0.1},
        "view_map": {"resolution": view_res}})
    want = jmaps.load_static_map(cfg_j)
    got = maps.load_static_map(cfg_t)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_grey_and_resize_match_cv2_on_random_images(tmp_path):
    """Every colour type the decoder takes, and non-binary grey levels —
    the repo's maps are 0/255 only, so this guards the rounding."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    for ch in (1, 3, 4):
        img = rng.integers(0, 256, (37, 53, ch) if ch > 1 else (37, 53))
        img = img.astype(np.uint8)
        if ch > 1:
            img[:3] = img[:3, :, :1]           # some grey pixels
        path = str(tmp_path / f"img{ch}.png")
        cv2.imwrite(path, img)
        grey = maps.to_grey(maps.decode_png(path))
        np.testing.assert_array_equal(
            grey, cv2.imread(path, cv2.IMREAD_GRAYSCALE))
        for h, w in ((246, 353), (74, 106), (20, 30)):
            np.testing.assert_array_equal(
                maps.resize_linear_u8(grey, h, w), cv2.resize(grey, (w, h)))


def test_config_fields_equal():
    """Every field equal but the map directory: the port reads its own
    copy of the PNGs (tests/test_torch_packaging.py holds them equal)."""
    d = small_cfg_dict()
    a = dataclasses.asdict(JaxEnvConfig.from_dict(d))
    b = dataclasses.asdict(EnvConfig.from_dict(d))
    assert os.path.samefile(a.pop("map_dir"), os.path.join(
        os.path.dirname(jmaps.__file__), "..", "maps"))
    assert os.path.samefile(b.pop("map_dir"), os.path.join(
        os.path.dirname(polar.__file__), "..", "maps"))
    assert a == b
    assert JaxEnvConfig.from_dict(d).n_substeps == \
        EnvConfig.from_dict(d).n_substeps


def test_footprints_and_resize_matrix():
    from img_env_tpu.ops import footprint as jfoot

    for r in (0.1, 0.17, 0.23):
        np.testing.assert_array_equal(footprint.circle_points(0.0, 0.0, r),
                                      jfoot.circle_points(0.0, 0.0, r))
    np.testing.assert_array_equal(
        footprint.rectangle_points(-0.15, 0.15, -0.1, 0.2),
        jfoot.rectangle_points(-0.15, 0.15, -0.1, 0.2))
    for dst, src in ((48, 400), (48, 60), (48, 64)):
        np.testing.assert_array_equal(resize.resize_matrix(dst, src),
                                      jresize.resize_matrix(dst, src))


@pytest.fixture(scope="module")
def kernel_statics():
    vp_t = view.ViewParams(*VP)
    ps_j = jpolar.PolarStatics.build(VP, n_chunks=8)
    ps_t = polar.PolarStatics.build(vp_t, n_chunks=8)
    pst_j = jpainter.PainterStatics.build(ps_j)
    pst_t = painter.PainterStatics.build(ps_t)
    return vp_t, ps_j, ps_t, pst_j, pst_t


def test_view_and_laser_tables(kernel_statics):
    vp_t = kernel_statics[0]
    for sensor in ((0.0, 0.0), (0.1, -0.05)):
        _assert_tree_equal(jview.ViewStatics.build(VP, sensor),
                           view.ViewStatics.build(vp_t, sensor))


def test_polar_statics(kernel_statics):
    _, ps_j, ps_t, _, _ = kernel_statics
    _assert_tree_equal(ps_j, ps_t)


def test_painter_and_kernel_tables(kernel_statics):
    _, _, _, pst_j, pst_t = kernel_statics
    _assert_tree_equal(pst_j, pst_t)
    # K3's layout: one CSR entry per painted slot, holding exactly the
    # visits of the JAX package's TPU painter tables (its width classes)
    kst_j = jpaint_t.PaintTStatics.build(pst_j)
    slots = painter.PaintSlots.build(pst_t)
    assert slots.off.shape == (pst_t.n_slots + 1,)
    got = set()
    for s in range(pst_t.n_slots):
        for v in slots.visits[slots.off[s]:slots.off[s + 1]].tolist():
            got.add((s, v >> 16, v & 0xFFFF))
    want = set()
    for cl in kst_j.classes:
        for i, s0 in enumerate(np.asarray(cl.slot0)):
            tb = np.asarray(cl.tb[i])                      # [G8, w]
            for g, w in zip(*np.nonzero(tb)):
                want.add((int(s0) + g, int(cl.rbase[i]) + w, int(tb[g, w])))
    ws = np.asarray(kst_j.wide_slots)
    for i, r in zip(*np.nonzero(np.asarray(kst_j.wide_sstep))):
        want.add((int(ws[i]), r, int(kst_j.wide_sstep[i, r])))
    assert got == want


def test_env_statics_match(tmp_path):
    """build_statics of the small env config: every table the step reads."""
    cfg_j = JaxEnvConfig.from_dict(small_cfg_dict())
    cfg_t = EnvConfig.from_dict(small_cfg_dict())
    sj = jnav.build_statics(cfg_j)
    stt = nav_env.build_statics(cfg_t)
    for f in ("static_map", "robot_points", "robot_mask", "robot_radius",
              "obs_points", "obs_point_dist", "obs_base_mask",
              "obs_is_circle", "own_slots", "own_slots_ok"):
        _assert_tree_equal(getattr(sj, f), getattr(stt, f), f)
    assert sj.resolution == stt.resolution
    _assert_tree_equal(sj.polar, stt.polar, "polar")
    _assert_tree_equal(sj.painter, stt.painter, "painter")
    _assert_tree_equal(sj.sampler, stt.sampler, "sampler")
    np.testing.assert_array_equal(
        jpolar.own_mask_sorted(sj.polar, sj.own_slots, sj.own_slots_ok),
        polar.own_mask_sorted(stt.polar, stt.own_slots, stt.own_slots_ok))
