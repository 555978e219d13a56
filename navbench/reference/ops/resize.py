"""cv2 INTER_CUBIC weights (host-side numpy copy of ``img_env_tpu.ops.resize``).

The reference downsamples each 400x400 view map to 48x48 with cv2
INTER_CUBIC (yaml_env.py:431-438): a = -0.75, 4 taps, replicate border, no
antialias on downscale.  ``resize_matrix`` gives the separable weights the
sorted-layout sensor-map tables are built from (ops/polar.py).
"""

from __future__ import annotations

import functools

import numpy as np

_A = -0.75  # cv2's Catmull-Rom-like coefficient


def _cubic_kernel(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    w = np.where(
        ax <= 1,
        ((_A + 2) * ax - (_A + 3)) * ax * ax + 1,
        np.where(ax < 2, ((_A * ax - 5 * _A) * ax + 8 * _A) * ax - 4 * _A, 0.0),
    )
    return w


@functools.lru_cache(maxsize=16)
def resize_matrix(dst: int, src: int) -> np.ndarray:
    """[dst, src] row-stochastic cubic interpolation weights."""
    scale = src / dst
    m = np.zeros((dst, src), np.float64)
    for i in range(dst):
        f = (i + 0.5) * scale - 0.5
        base = int(np.floor(f))
        dx = f - base
        taps = np.array([base - 1, base, base + 1, base + 2])
        wts = _cubic_kernel(np.array([1 + dx, dx, 1 - dx, 2 - dx]))
        for t, wt in zip(taps, wts):
            m[i, min(max(t, 0), src - 1)] += wt
    return m
