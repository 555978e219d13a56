"""Laser -> image encodings (torch port of ``img_env_tpu.utils.lidar``, the
batched form of envs/utils/lidar_process.py).

All functions take ``[..., R]`` range tensors (meters) on any device and
compute in float32, as the JAX package does; the reference's per-beam
Python loops become one broadcasted comparison against the bin edges.
The edges of the log-spaced strip come from ``ops.f32.exp`` and
``ops.f32.log``, which give XLA's float32 bits: torch's own ``exp`` and
``log`` differ from XLA's in the last bits, and a range within a few ulp
of an edge would move a cell.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from img_env_tpu_torch.ops import f32
from img_env_tpu_torch.ops.raster import div_const


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def _strip(ld, e_left, e_right, beyond: float, at: float):
    """``beyond`` where the cell's right edge is at or before the range,
    ``at`` where the range falls in the cell, 0.5 before it."""
    ld = ld[..., None]
    return torch.where(e_right <= ld, beyond,
                       torch.where(e_left <= ld, at, 0.5)).to(torch.float32)


def down_sample(lidar, sample_num: int, is_circle: bool = False,
                max_range: float = 6.0):
    """Min-pool each consecutive ``sample_num`` beams, clip to max_range
    (lidar_process.py:20-32)."""
    lidar = _f32(lidar)
    if is_circle:
        lidar = lidar[..., 288:-288]
    n = lidar.shape[-1] // sample_num
    pooled = lidar[..., : n * sample_num].reshape(
        lidar.shape[:-1] + (n, sample_num))
    return torch.clamp(pooled.amin(-1), max=max_range)


def normal_sample(lidar, sample_num: int):
    """Strided subsample (lidar_process.py:35-40)."""
    lidar = _f32(lidar)
    n = lidar.shape[-1] // sample_num
    return lidar[..., : n * sample_num: sample_num]


def lidar_to_map(lidar, length: int, max_range: float = 6.0):
    """Linear occupancy strip per beam: 1 beyond-hit, 0 at-hit, 0.5 inside
    (lidar_process.py:43-59).  Returns [..., R, length]."""
    lidar = _f32(lidar)
    gap = max_range / length
    idx = np.arange(length)
    left = torch.as_tensor(idx * gap, dtype=torch.float32,
                           device=lidar.device)
    right = torch.as_tensor((idx + 1) * gap, dtype=torch.float32,
                            device=lidar.device)
    return _strip(lidar, left, right, 1.0, 0.0)


def log_map_edges(max_dis, length: int, max_range: float = 6.0):
    """The log-spaced strip's bin edges ([length] each): e^(i g) - 1 and
    min(e^((i+1) g) - 1, max_range) with g = log(max_dis + 1) / length,
    as XLA computes them (its exp and log; the division a product with
    the float32 reciprocal of ``length``)."""
    gap = div_const(f32.log(max_dis + 1.0), length)
    idx = torch.arange(length, device=gap.device).to(torch.float32)
    e_left = f32.exp(idx * gap) - 1.0
    e_right = torch.clamp(f32.exp((idx + 1.0) * gap) - 1.0, max=max_range)
    return e_left, e_right


def lidar_log_map(lidar, length: int, max_range: float = 6.0):
    """Log-spaced strip (lidar_process.py:67-88): cells 0 beyond, 1 at hit,
    0.5 before.  Bin edges e^x-1 in log(max+1)/length steps, where max is
    the largest range of the whole input (at least max_range)."""
    lidar = _f32(lidar)
    max_dis = torch.clamp(lidar.amax(), min=max_range)
    return _strip(lidar, *log_map_edges(max_dis, length, max_range),
                  0.0, 1.0)


def lidar_e_map(lidar, length: int, max_range: float = 6.0):
    """Exp-spaced strip (lidar_process.py:91-109)."""
    lidar = _f32(lidar)
    gap = (math.e ** max_range - 1.0) / length
    idx = np.arange(length)
    e_left = torch.as_tensor(np.log(idx * gap + 1.0), dtype=torch.float32,
                             device=lidar.device)
    e_right = torch.clamp(torch.as_tensor(
        np.log((idx + 1) * gap + 1.0), dtype=torch.float32,
        device=lidar.device), max=max_range)
    return _strip(lidar, e_left, e_right, 0.0, 1.0)


def polar_indices(r_bins: int, l_bins: int, out_size: int,
                  log_radius: bool = False):
    """Host int64 (angle, radius) strip indices of each [out, out] pixel:
    the cv2.linearPolar/logPolar WARP_INVERSE_MAP step
    (lidar_process.py:112-124), in float64 numpy as the JAX package
    computes them."""
    c = out_size / 2.0
    ys, xs = np.mgrid[0:out_size, 0:out_size]
    dx, dy = xs - c, ys - c
    rho = np.hypot(dx, dy)
    phi = np.mod(np.arctan2(dy, dx), 2 * np.pi)
    max_radius = math.hypot(c, c)
    if log_radius:
        m = out_size / math.log(max_radius) * 0.99
        r_idx = np.clip((np.log(np.maximum(rho, 1e-6)) * m) * l_bins
                        / out_size, 0, l_bins - 1).astype(np.int32)
    else:
        r_idx = np.clip(rho / (max_radius * 1.1) * l_bins, 0,
                        l_bins - 1).astype(np.int32)
    a_idx = np.clip(phi / (2 * np.pi) * r_bins, 0,
                    r_bins - 1).astype(np.int32)
    return a_idx.astype(np.int64), r_idx.astype(np.int64)


def polar_to_cartesian(strip, out_size: int, log_radius: bool = False):
    """Inverse-polar resampling of a [..., R, L] strip into a [..., out,
    out] image: a gather at ``polar_indices``."""
    a_idx, r_idx = polar_indices(strip.shape[-2], strip.shape[-1], out_size,
                                 log_radius)
    dev = strip.device
    return strip[..., torch.from_numpy(a_idx).to(dev),
                 torch.from_numpy(r_idx).to(dev)]


def trans_lidar_log_map(lasers, sample_num: int = 20, length: int = 48):
    """Full pipeline of _trans_lidar_log_map (lidar_process.py:8-16)."""
    strip = lidar_log_map(down_sample(lasers, sample_num), length)
    return polar_to_cartesian(strip, length, log_radius=False)
