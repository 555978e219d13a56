"""Euclidean distance transforms for planning costs (torch port of
``img_env_tpu.mpc.edt``).

``edt2d`` is the exact Felzenszwalb & Huttenlocher two-pass squared EDT in
NumPy, on the host (pure-Python loops: seconds on a 1066^2 map).
``edt2d_device`` runs on the environment's device at every reset, over the
episode's composed obstacle map: a log-shift column scan plus a clipped
min-plus row pass, exact up to ``clip_cells``.
"""

from __future__ import annotations

import numpy as np
import torch

_INF = 1e12


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
    """On-device EDT, exact up to ``clip_cells`` then saturated.

    Column pass: log-shift (min,+) passes give each cell's vertical distance
    to the nearest occupied cell.  Row pass: min-plus against the parabola
    (j-k)^2 for |j-k| <= clip_cells — planning costs saturate beyond the
    clearance band, so the clipped transform is exact where it matters.
    """
    h, w = occupied.shape
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=occupied.device)
    g = torch.where(occupied, torch.zeros((), dtype=torch.float32,
                                          device=occupied.device), inf)
    shift = 1
    while shift < h:
        pad = torch.full((shift, w), float("inf"), dtype=torch.float32,
                         device=occupied.device)
        up = torch.cat([pad, g[:-shift]], 0)
        dn = torch.cat([g[shift:], pad], 0)
        g = torch.minimum(g, torch.minimum(up, dn) + shift)
        shift *= 2
    g2 = torch.clamp(g, max=float(clip_cells)) ** 2
    d2 = torch.full((h, w), float("inf"), dtype=torch.float32, device=occupied.device)
    j = torch.arange(w, device=occupied.device)
    for o in range(-clip_cells, clip_cells + 1):
        rolled = torch.roll(g2, o, dims=1)
        valid = (j >= o) if o >= 0 else (j < w + o)
        cand = torch.where(valid[None, :], rolled + float(o) ** 2, inf)
        d2 = torch.minimum(d2, cand)
    return torch.sqrt(d2) * resolution
