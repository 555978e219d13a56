"""Euclidean distance transforms for planning costs (torch port of
``img_env_tpu.mpc.edt``).

``edt2d`` is the exact Felzenszwalb & Huttenlocher two-pass squared EDT in
NumPy, on the host (pure-Python loops: seconds on a 1066^2 map).
``edt2d_device`` runs on the environment's device at every reset, over the
episode's composed obstacle map: the vertical distance to the nearest
occupied cell of the column, then a clipped min-plus row pass, exact up to
``clip_cells``.  On CUDA tensors it is one launch of csrc/edt.cu (two device
kernels); its plain-torch twin ``edt2d_twin`` (a log-shift column scan, then
one roll / where / minimum round per row offset) runs for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from img_env_tpu_torch.ops import kernels
from img_env_tpu_torch.utils import trace

_INF = 1e12
# csrc/edt.cu: clip^2 stays exact in float32; a block's shared memory
# (227 KB on the H100) holds the column pass's h words beside its 8 KB of
# segment carries, and the row pass's w + 2 clip floats
EDT_MAX_CLIP = 4095
EDT_SMEM_BYTES = 232_448


def _dt1d(f: np.ndarray) -> np.ndarray:
    """Exact 1D squared distance transform (lower envelope of parabolas)."""
    n = f.shape[0]
    d = np.empty(n)
    v = np.zeros(n, np.int64)
    z = np.empty(n + 1)
    k = 0
    v[0] = 0
    z[0] = -_INF
    z[1] = _INF
    for q in range(1, n):
        s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2 * q - 2 * v[k])
        while s <= z[k]:
            k -= 1
            s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2 * q - 2 * v[k])
        k += 1
        v[k] = q
        z[k] = s
        z[k + 1] = _INF
    k = 0
    for q in range(n):
        while z[k + 1] < q:
            k += 1
        d[q] = (q - v[k]) ** 2 + f[v[k]]
    return d


def edt2d(occupied: np.ndarray, resolution: float = 1.0) -> np.ndarray:
    """Exact EDT (meters) of a boolean occupancy grid, host-side."""
    h, w = occupied.shape
    f = np.where(occupied, 0.0, _INF)
    for i in range(h):
        f[i] = _dt1d(f[i])
    for j in range(w):
        f[:, j] = _dt1d(f[:, j])
    return np.sqrt(f) * resolution


def edt2d_device(occupied: torch.Tensor, resolution: float,
                 clip_cells: int = 128) -> torch.Tensor:
    """On-device EDT (meters, float32) of bool ``occupied`` [H, W] or
    [S, H, W], exact up to ``clip_cells`` then saturated: the kernel on
    CUDA tensors, ``edt2d_twin`` on CPU tensors."""
    if occupied.is_cuda:
        return edt2d_kernel(occupied, resolution, clip_cells)
    return edt2d_twin(occupied, resolution, clip_cells)


def edt2d_kernel(occupied: torch.Tensor, resolution: float,
                 clip_cells: int = 128) -> torch.Tensor:
    """``edt2d_twin`` in one launch of csrc/edt.cu, bit for bit."""
    if occupied.dtype != torch.bool or occupied.dim() not in (2, 3):
        raise ValueError("EDT kernel takes a bool [H, W] or [S, H, W] map")
    kernels.check_cuda(occupied)
    maps = occupied if occupied.dim() == 3 else occupied[None]
    scenes, h, w = maps.shape
    if not 0 <= clip_cells <= EDT_MAX_CLIP:
        raise ValueError(f"EDT kernel takes clip_cells in [0, "
                         f"{EDT_MAX_CLIP}], not {clip_cells}")
    if (4 * h + 8192 > EDT_SMEM_BYTES
            or 4 * (w + 2 * clip_cells) > EDT_SMEM_BYTES or scenes > 65535):
        raise ValueError(f"EDT kernel: a {tuple(maps.shape)} map at clip "
                         f"{clip_cells} does not fit a block's shared memory")
    out = torch.empty(occupied.shape, dtype=torch.float32,
                      device=occupied.device)
    if out.numel():
        kernels.launch("edt", maps.data_ptr(), scenes, h, w, clip_cells,
                       resolution, out.data_ptr())
        trace.count("edt.kernel_scenes", scenes)
    return out


def edt2d_sq_twin(occupied: torch.Tensor,
                  clip_cells: int = 128) -> torch.Tensor:
    """Plain-torch squared clipped EDT in cells (float32, the shape of bool
    ``occupied`` [..., H, W]).

    Column pass: log-shift (min,+) passes give each cell's vertical distance
    to the nearest occupied cell.  Row pass: min-plus against the parabola
    (j-k)^2 for |j-k| <= clip_cells — planning costs saturate beyond the
    clearance band, so the clipped transform is exact where it matters.
    """
    h, w = occupied.shape[-2:]
    lead = occupied.shape[:-2]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=occupied.device)
    g = torch.where(occupied, torch.zeros((), dtype=torch.float32,
                                          device=occupied.device), inf)
    shift = 1
    while shift < h:
        pad = torch.full((*lead, shift, w), float("inf"), dtype=torch.float32,
                         device=occupied.device)
        up = torch.cat([pad, g[..., :-shift, :]], -2)
        dn = torch.cat([g[..., shift:, :], pad], -2)
        g = torch.minimum(g, torch.minimum(up, dn) + shift)
        shift *= 2
    g2 = torch.clamp(g, max=float(clip_cells)) ** 2
    d2 = torch.full(occupied.shape, float("inf"), dtype=torch.float32,
                    device=occupied.device)
    j = torch.arange(w, device=occupied.device)
    for o in range(-clip_cells, clip_cells + 1):
        rolled = torch.roll(g2, o, dims=-1)
        valid = (j >= o) if o >= 0 else (j < w + o)
        cand = torch.where(valid, rolled + float(o) ** 2, inf)
        d2 = torch.minimum(d2, cand)
    return d2


def edt2d_twin(occupied: torch.Tensor, resolution: float,
               clip_cells: int = 128) -> torch.Tensor:
    """Plain-torch EDT (meters): the square root of ``edt2d_sq_twin``
    times the resolution."""
    return torch.sqrt(edt2d_sq_twin(occupied, clip_cells)) * resolution
