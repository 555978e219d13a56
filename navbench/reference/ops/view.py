"""Egocentric view and laser geometry (host-side numpy copy of the
``img_env_tpu.ops.view`` builders).

The reference renders, per robot, a 400x400 window by per-pixel inverse
transform and then walks one integer Bresenham line per laser beam over it
(agent.cpp:356-624).  The raycast uses a *closed form* of Bresenham's
midpoint walk: for the major-axis step u, the minor offset is
``floor((2*h*u - w) / (2*w)) + 1`` (u >= 0), which reproduces the C++
loop's visited cells exactly.  These static tables feed the sorted-layout
sensor pipeline (ops/polar.py, ops/painter.py); the per-robot gather
renderer (``sensor_mode='reference'``) is not part of the port.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np

from navbench.reference.constants import ANGULAR_MAP_SIZE, VIEW_YAW


class ViewParams(NamedTuple):
    """Static sensor geometry (hashable)."""

    hpx: int
    wpx: int
    resolution: float
    half: float                 # height/2 in meters (view frame origin offset)
    angle_begin: float
    angle_end: float
    min_dist: float
    max_dist: float
    range_total: int
    use_laser: bool

    @staticmethod
    def from_config(cfg) -> "ViewParams":
        hpx, wpx = cfg.view_pixels
        return ViewParams(
            hpx=hpx,
            wpx=wpx,
            resolution=float(cfg.view_map_resolution),
            half=float(cfg.view_map_size[1]) / 2.0,
            angle_begin=float(cfg.view_angle_begin),
            angle_end=float(cfg.view_angle_end),
            min_dist=float(cfg.view_min_dist),
            max_dist=float(cfg.view_max_dist),
            range_total=int(cfg.range_total),
            use_laser=bool(cfg.use_laser),
        )


# ---------------------------------------------------------------------------
# Static per-config geometry (host-side numpy).
# ---------------------------------------------------------------------------


def _pixel_base_coords(p: ViewParams) -> Tuple[np.ndarray, np.ndarray]:
    """Base-frame (x, y) of every view pixel center. [hpx, wpx] each."""
    i = np.arange(p.hpx, dtype=np.float64) * p.resolution
    j = np.arange(p.wpx, dtype=np.float64) * p.resolution
    xv, yv = np.meshgrid(i, j, indexing="ij")
    c, s = math.cos(VIEW_YAW), math.sin(VIEW_YAW)
    xb = c * xv - s * yv + p.half
    yb = s * xv + c * yv + p.half
    return xb, yb


def _beam_endpoints(p: ViewParams) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(endpoint cells [R,2], beam angles [R], origin offset) for sensor at
    base origin; a nonzero sensor offset shifts the origin pixel instead."""
    max_range = math.hypot(p.half, p.half)
    astep = abs(p.angle_end - p.angle_begin) / p.range_total
    angles = p.angle_begin + astep * np.arange(p.range_total)
    xb = max_range * np.cos(angles)
    yb = max_range * np.sin(angles)
    c, s = math.cos(VIEW_YAW), math.sin(VIEW_YAW)
    # base2view = inverse of tf_view_base_ (see core/frames.py)
    xvv = c * xb + s * yb - (c * p.half + s * p.half)
    yvv = -s * xb + c * yb - (-s * p.half + c * p.half)
    cells = np.stack(
        [np.where(xvv >= 0, np.floor(xvv / p.resolution + 0.5), np.ceil(xvv / p.resolution - 0.5)),
         np.where(yvv >= 0, np.floor(yvv / p.resolution + 0.5), np.ceil(yvv / p.resolution - 0.5))],
        axis=-1,
    ).astype(np.int32)
    return cells, angles, max_range


def sensor_origin_cell(p: ViewParams, sensor_base=(0.0, 0.0)) -> np.ndarray:
    c, s = math.cos(VIEW_YAW), math.sin(VIEW_YAW)
    sx, sy = sensor_base
    xv = c * sx + s * sy - (c * p.half + s * p.half)
    yv = -s * sx + c * sy - (-s * p.half + c * p.half)
    r = lambda v: int(np.floor(v / p.resolution + 0.5)) if v >= 0 else int(np.ceil(v / p.resolution - 0.5))
    return np.array([r(xv), r(yv)], np.int32)


# ---------------------------------------------------------------------------
# FOV fill
# ---------------------------------------------------------------------------


def fov_mask(p: ViewParams, sensor_base=(0.0, 0.0)) -> np.ndarray:
    """Static [hpx, wpx] bool: pixel passes the angle/range gates
    (agent.cpp:381-385).  Depends only on geometry, not on the scene."""
    xb, yb = _pixel_base_coords(p)
    ang = np.arctan2(yb - sensor_base[1], xb - sensor_base[0])
    return (
        (ang > p.angle_begin)
        & (ang < p.angle_end)
        & (xb >= p.min_dist)
        & (xb <= p.max_dist)
    )


def _bresenham_cells(p: ViewParams, origin: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Static [R, S, 2] visited cells per beam + [R, S] validity.

    Closed form of the C++ midpoint walk (agent.cpp:511-624): with
    w = |x2-x1| > h = |y2-y1|, visit u has x = x1 + dx*u and
    y = y1 + dy*(floor((2*h*u - w) / (2*w)) + 1); the loop visits
    u in [0, w) (endpoint excluded).  Symmetric for the steep case.
    """
    ends, _, _ = _beam_endpoints(p)
    x1, y1 = int(origin[0]), int(origin[1])
    r = ends.shape[0]
    wv = ends[:, 0] - x1
    hv = ends[:, 1] - y1
    dx = np.where(wv > 0, 1, -1)
    dy = np.where(hv > 0, 1, -1)
    aw, ah = np.abs(wv), np.abs(hv)
    smax = int(max(aw.max(initial=1), ah.max(initial=1)))
    u = np.arange(smax)[None, :]                      # [1,S]

    flat = aw > ah
    major = np.where(flat, aw, ah)[:, None]           # [R,1]
    minor = np.where(flat, ah, aw)[:, None]
    dmaj = np.where(flat, dx, dy)[:, None]
    dmin = np.where(flat, dy, dx)[:, None]
    # guard minor==... major>0 always (beams leave the origin)
    off = np.floor_divide(2 * minor * u - major, 2 * major) + 1
    off = np.where(u == 0, 0, off)                    # u=0 -> offset 0
    maj_c = (np.where(flat, x1, y1)[:, None]) + dmaj * u
    min_c = (np.where(flat, y1, x1)[:, None]) + dmin * off
    xs = np.where(flat[:, None], maj_c, min_c)
    ys = np.where(flat[:, None], min_c, maj_c)
    valid = u < major
    return np.stack([xs, ys], axis=-1).astype(np.int32), valid


def beam_walk_tables(ls: "LaserStatics", p: ViewParams):
    """Static walk structure for the exact laser-map trace.

    Returns (eff [R,S] bool — samples the C++ loop actually visits (in-map
    and before the first out-of-map cell, agent.cpp:536,562), nxt [R,S]
    int32 — the first step after s whose MINOR coordinate differs).

    ``nxt`` encodes the post-hit skip rule: the major coordinate strictly
    increases along a walk (the for-loop increments it every iteration,
    agent.cpp:532/580), so ``cur != end`` can only fail on the minor axis —
    the skip set after a hit at step s is exactly the contiguous run
    [s+1, nxt[s]) sharing the hit cell's minor coordinate.
    """
    cells, valid = ls.cells, ls.valid
    r, s = valid.shape
    hpx, wpx = p.hpx, p.wpx
    inb = ((cells[..., 0] >= 0) & (cells[..., 0] < hpx)
           & (cells[..., 1] >= 0) & (cells[..., 1] < wpx))
    oob = valid & ~inb
    first_oob = np.where(oob.any(1), oob.argmax(1), s)
    eff = valid & inb & (np.arange(s)[None, :] < first_oob[:, None])

    ends, _, _ = _beam_endpoints(p)
    x1, y1 = int(ls.origin[0]), int(ls.origin[1])
    flat = np.abs(ends[:, 0] - x1) > np.abs(ends[:, 1] - y1)   # x is major
    minor = np.where(flat[:, None], cells[..., 1], cells[..., 0])

    big = np.int32(2 ** 14)
    nxt = np.full((r, s), big, np.int32)
    if s >= 2:
        change = minor[:, 1:] != minor[:, :-1]
        for k in range(s - 2, -1, -1):
            nxt[:, k] = np.where(change[:, k], k + 1, nxt[:, k + 1])
    return eff, nxt


class LaserStatics(NamedTuple):
    """Host-precomputed raycast geometry for one sensor placement."""

    cells: np.ndarray          # [R,S,2]
    valid: np.ndarray          # [R,S]
    dists: np.ndarray          # [R,S] world distance origin->cell center
    angles: np.ndarray         # [R]
    angular_bin: np.ndarray    # [R] int32
    origin: np.ndarray         # [2]

    @staticmethod
    def build(p: ViewParams, sensor_base=(0.0, 0.0)) -> "LaserStatics":
        origin = sensor_origin_cell(p, sensor_base)
        cells, valid = _bresenham_cells(p, origin)
        d = np.hypot(
            (cells[..., 0] - origin[0]).astype(np.float64) * p.resolution,
            (cells[..., 1] - origin[1]).astype(np.float64) * p.resolution,
        )
        _, angles, _ = _beam_endpoints(p)
        astep = abs(p.angle_end - p.angle_begin) / p.range_total
        ang_map_step = abs(p.angle_end - p.angle_begin) / ANGULAR_MAP_SIZE
        bins = (astep * np.arange(p.range_total) / ang_map_step).astype(np.int32)
        bins = np.clip(bins, 0, ANGULAR_MAP_SIZE - 1)
        return LaserStatics(
            cells=cells, valid=valid, dists=d, angles=angles,
            angular_bin=bins, origin=origin,
        )


class ViewStatics(NamedTuple):
    """The fields of the JAX ``ViewStatics`` that the sorted layout reads
    (the gather renderer's pixel tables are not built)."""

    gates: np.ndarray          # [hpx,wpx] bool
    pix_beam: np.ndarray       # [hpx,wpx] int32 nearest beam index
    laser: LaserStatics

    @staticmethod
    def build(p: ViewParams, sensor_base=(0.0, 0.0)) -> "ViewStatics":
        xb, yb = _pixel_base_coords(p)
        gates = fov_mask(p, sensor_base)
        ang = np.arctan2(yb - sensor_base[1], xb - sensor_base[0])
        astep = abs(p.angle_end - p.angle_begin) / p.range_total
        beam = np.clip(
            np.floor((ang - p.angle_begin) / astep), 0, p.range_total - 1
        ).astype(np.int32)
        return ViewStatics(gates=gates, pix_beam=beam,
                           laser=LaserStatics.build(p, sensor_base))


def own_view_cells(bbox_points, bbox_mask, p: ViewParams):
    """Footprint cells in view-pixel space (static per robot shape).

    ``Agent::draw(view_map, 100, "view_map")`` transforms base-frame bbox
    points with base2view and quantizes (agent.cpp:307-311).
    """
    c, s = math.cos(VIEW_YAW), math.sin(VIEW_YAW)
    xb, yb = bbox_points[..., 0], bbox_points[..., 1]
    xv = c * xb + s * yb - (c * p.half + s * p.half)
    yv = -s * xb + c * yb - (-s * p.half + c * p.half)
    r = lambda v: np.where(v >= 0, np.floor(v / p.resolution + 0.5), np.ceil(v / p.resolution - 0.5))
    return np.stack([r(xv), r(yv)], axis=-1).astype(np.int32), bbox_mask
