"""Quaternion / SE(3) helpers (envs/utils/ros_utils.py without tf; the
port's own copy of ``img_env_tpu.utils.transforms``, plain numpy).

Pure-numpy replacements for the tf.transformations calls the reference
wraps: matrix <-> translation+quaternion, yaw extraction, point transforms.
Convention: quaternions are (x, y, z, w), matrices are 4x4 homogeneous.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np


def quaternion_from_yaw(yaw: float) -> np.ndarray:
    return np.asarray([0.0, 0.0, math.sin(yaw / 2), math.cos(yaw / 2)])


def yaw_from_quaternion(q: Sequence[float]) -> float:
    x, y, z, w = q
    return math.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def matrix_from_t_q(t: Sequence[float], q: Sequence[float]) -> np.ndarray:
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    m = np.asarray([
        [1 - (yy + zz), xy - wz, xz + wy, t[0]],
        [xy + wz, 1 - (xx + zz), yz - wx, t[1]],
        [xz - wy, yz + wx, 1 - (xx + yy), t[2]],
        [0, 0, 0, 1.0],
    ])
    return m


def t_from_matrix(m: np.ndarray) -> np.ndarray:
    return np.asarray(m)[:3, 3].copy()


def rpy_from_matrix(m: np.ndarray) -> Tuple[float, float, float]:
    m = np.asarray(m)
    sy = math.hypot(m[0, 0], m[1, 0])
    if sy > 1e-8:
        roll = math.atan2(m[2, 1], m[2, 2])
        pitch = math.atan2(-m[2, 0], sy)
        yaw = math.atan2(m[1, 0], m[0, 0])
    else:
        roll = math.atan2(-m[1, 2], m[1, 1])
        pitch = math.atan2(-m[2, 0], sy)
        yaw = 0.0
    return roll, pitch, yaw


def inverse(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m)
    r = m[:3, :3].T
    out = np.eye(4)
    out[:3, :3] = r
    out[:3, 3] = -r @ m[:3, 3]
    return out


def mul_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.asarray(a) @ np.asarray(b)


def transform_point(m: np.ndarray, p: Sequence[float]) -> np.ndarray:
    v = np.asarray([p[0], p[1], p[2] if len(p) > 2 else 0.0, 1.0])
    return (np.asarray(m) @ v)[:3]
