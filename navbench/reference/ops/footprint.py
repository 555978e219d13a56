"""Footprint point clouds (host-side numpy copy of ``img_env_tpu.ops.footprint``).

The reference rasterizes every agent by stamping a precomputed point cloud
sampled on a 0.01 m grid (agent.cpp:18-62).  Collision codes are read off the
occupancy grid at exactly those points, so the same point sets are rebuilt
here; the tests hold them array-equal to the JAX package's builders.
"""

from __future__ import annotations

import math

import numpy as np

from navbench.reference.constants import FOOTPRINT_RES


def circle_points(cx: float, cy: float, r: float) -> np.ndarray:
    """Grid points inside a circle — Agent::init_shape_circle (agent.cpp:18-30)."""
    res = FOOTPRINT_RES
    bb = int(math.ceil(r / res))
    m = np.arange(-bb, bb + 1, dtype=np.float64)
    mm, nn = np.meshgrid(m, m, indexing="ij")
    mask = np.sqrt((mm * res) ** 2 + (nn * res) ** 2) <= r
    pts = np.stack([mm[mask] * res + cx, nn[mask] * res + cy], axis=-1)
    return pts.astype(np.float32)


def rectangle_points(x0: float, x1: float, y0: float, y1: float) -> np.ndarray:
    """Axis-aligned rectangle — Agent::init_shape_rectangle (agent.cpp:51-62)."""
    res = FOOTPRINT_RES
    xs = np.arange(int(math.floor(x0 / res)), int(math.ceil(x1 / res)) + 1)
    ys = np.arange(int(math.floor(y0 / res)), int(math.ceil(y1 / res)) + 1)
    mm, nn = np.meshgrid(xs.astype(np.float64), ys.astype(np.float64), indexing="ij")
    pts = np.stack([mm.ravel() * res, nn.ravel() * res], axis=-1)
    return pts.astype(np.float32)


def bounding_radius(shape: str, sizes) -> float:
    """Module size used by the scenario sampler (reset_helper.py:14-27),
    including get_robot_radius's permissiveness for unknown shapes."""
    if shape == "circle":
        return float(sizes[2])
    if shape == "rectangle":
        return float(math.sqrt(sizes[0] ** 2 + sizes[2] ** 2))
    if shape == "leg":
        return float(sizes[-1] + sizes[-2])
    if shape == "L" and len(sizes) >= 4:
        return float(math.sqrt(sizes[1] ** 2 + sizes[3] ** 2))
    if shape == "sweep" and len(sizes) >= 4:
        return float(sizes[3] + sizes[1])
    return 0.0
