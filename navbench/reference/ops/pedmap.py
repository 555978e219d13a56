"""The 3-channel pedestrian map (occupancy, vx, vy) of every robot, with
kernel K4 (csrc/pedmap.cu).

The reference draws each range-sorted pedestrian's disc into the robot's
48x48 map over +-3 m in order, later (farther) peds overwriting earlier
pixels (yaml_env.py:392-458).  A pixel (h, w) of robot n is covered by
ped i when the ped lies in the window, the pixel centre is strictly
inside the disc of radius ``ped_image_r``, and the pixel index lies in the
floor-div box [floor((t - r)/res), floor((t + r)/res)) of the reference
(``pixel_cover_bounds_exact``).

``ped_map_twin`` is the plain-torch version: stable sort by range^2, then
the maximal covering sorted position per pixel.  Kernel K4 needs no sort:
the last sorted writer is the lexicographic max of (range^2, original
index) over the covering peds, which it finds as the max of the 64-bit
key (float_bits(range^2) << 32) | (index + 1).  Both compute every float
the same way: range^2 is one fused multiply-add (as XLA compiles the JAX
package's ``px * px + py * py``), flushed to +0 where it is subnormal (as
XLA's CPU build flushes it), the box bounds divide through the float32
reciprocal of ``res``, everything else rounds per operation.
"""

from __future__ import annotations

import numpy as np
import torch

from navbench.reference.ops.f32 import fma
from navbench.reference.ops.raster import div_const

HALF = 3.0                # the map covers +-3 m around the robot
PEDMAP_MAX_PIXELS = 64 * 64   # csrc/pedmap.cu: one 64-bit key per pixel
                              # in 32 KB of shared memory


def range_sq(px, py):
    """Base-frame range^2, contracted as XLA contracts it in float32, and
    +0 where it falls below the smallest normal float: XLA's CPU build
    flushes subnormal results to zero (as the TPU does), so a ped at a
    subnormal range^2 ties with one on the robot."""
    r = fma(px, px, py * py)
    return torch.where(r < torch.finfo(r.dtype).tiny, 0.0, r)


def _r2(ped_image_r: float) -> float:
    """The disc's squared radius as the JAX package compares it: squared
    in double, then rounded to float32."""
    return float(np.float32(float(ped_image_r) ** 2))


def pixel_cover_bounds_exact(tmx, tmy, res: float, ped_image_r: float,
                             image_size: int):
    """The reference tests only pixels whose index lies in the floor-div box
    [floor((tm-r)/res), floor((tm+r)/res)) (yaml_env.py:414-418), so a
    covering pixel at the box's right-open edge is skipped.  tmx/tmy
    [..., M]; returns (in_x, in_y) bool [..., M, image_size]."""
    lo_x = torch.floor(div_const(tmx - ped_image_r, res))
    hi_x = torch.floor(div_const(tmx + ped_image_r, res))
    lo_y = torch.floor(div_const(tmy - ped_image_r, res))
    hi_y = torch.floor(div_const(tmy + ped_image_r, res))
    idx = torch.arange(image_size, dtype=tmx.dtype, device=tmx.device)
    in_x = (idx >= lo_x[..., None]) & (idx < hi_x[..., None])
    in_y = (idx >= lo_y[..., None]) & (idx < hi_y[..., None])
    return in_x, in_y


def _cover(px, py, res: float, ped_image_r: float, hs: int):
    """bool [n, M, hs, hs]: ped i covers pixel (h, w)."""
    jj = (torch.arange(hs, dtype=px.dtype, device=px.device) + 0.5) * res
    tmx = -px + HALF
    tmy = -py + HALF
    in_win = (px <= HALF) & (px >= -HALF) & (py <= HALF) & (py >= -HALF)
    dx = jj - tmx[..., None]                               # [n,M,hs]
    dy = jj - tmy[..., None]
    d2 = (dx * dx)[..., :, None] + (dy * dy)[..., None, :]
    in_x, in_y = pixel_cover_bounds_exact(tmx, tmy, res, ped_image_r, hs)
    r2 = _r2(ped_image_r)
    return ((d2 < r2) & in_win[..., None, None]
            & in_x[..., :, None] & in_y[..., None, :])


def ped_map_twin(px, py, vx, vy, res: float, ped_image_r: float,
                 image_size: int, robot_chunk: int = 16):
    """Plain-torch K4: [N, 3, hs, hs] from unsorted base-frame ped
    positions / velocities [N, M], ``robot_chunk`` robots at a time (the
    cover tensor is [chunk, M, hs, hs])."""
    n, m = px.shape
    hs = image_size
    outs = []
    for a in range(0, n, robot_chunk):
        sl = slice(a, a + robot_chunk)
        order = torch.argsort(range_sq(px[sl], py[sl]), dim=1, stable=True)
        tk = lambda x: torch.gather(x[sl], 1, order)
        cover = _cover(tk(px), tk(py), res, ped_image_r, hs)
        pos = torch.arange(m, device=px.device)[None, :, None, None]
        last = torch.where(cover, pos, torch.full_like(pos, -1)).amax(dim=1)
        hit = last >= 0
        idx = last.clamp(min=0).reshape(last.shape[0], -1)
        sel = lambda x: torch.gather(tk(x), 1, idx).reshape(hit.shape)
        zero = torch.zeros_like(px[sl, :1, None])
        outs.append(torch.stack([
            hit.to(px.dtype),
            torch.where(hit, sel(vx), zero),
            torch.where(hit, sel(vy), zero)], dim=1))
    if not outs:
        return px.new_zeros((0, 3, hs, hs))
    return torch.cat(outs)


def ped_map(px, py, vx, vy, res: float, ped_image_r: float,
            image_size: int):
    """[N, 3, hs, hs] ped map: K4 for CUDA tensors, its twin for CPU
    tensors."""
    if px.shape[1] == 0:
        return px.new_zeros((px.shape[0], 3, image_size, image_size))
    return ped_map_twin(px, py, vx, vy, res, ped_image_r, image_size)
