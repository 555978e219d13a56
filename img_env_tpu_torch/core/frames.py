"""SE(2) frame algebra (torch port of ``img_env_tpu.core.frames``).

All transforms are ``(tx, ty, yaw)`` triples or tensors whose last
dimension holds ``(x, y[, yaw])``, over any leading batch dims.

Conventions follow the reference simulator (tf-based, z-up planar):
  * ``world_from_base(pose)`` maps base-frame points to world frame where
    ``pose = (x, y, theta)`` is the robot pose.
  * The egocentric *view* frame is related to the base frame by a rotation
    of ``VIEW_YAW`` (the literal 3.14159 the reference feeds tf,
    agent.cpp:84-88) and a translation of (half_h, half_w).

In float32 the rotations have the bits of the JAX package's jitted CPU
program: glibc's sin/cos of the angle (``ops/f32.sin_cos``), the
constant VIEW_YAW's cos/sin folded correctly rounded, and each two-term
row ``a*x + b*y`` contracted into one fused multiply-add
(``ops/f32.fma``) over the product XLA fuses: the first, ``fma(a, x,
b*y)``, in a row written ``c*x + s*y``; the second, ``fma(b, y, a*x)``,
in a row written ``-s*x + c*y`` and in the einsum of a rotation matrix.
``wrap_angle``'s atan2 is torch's, within one float32 ulp of XLA's.
"""

from __future__ import annotations

import math

import torch

from img_env_tpu_torch.constants import VIEW_YAW
from img_env_tpu_torch.ops import f32

Tensor = torch.Tensor


def _view_cs(like: Tensor):
    """cos and sin of VIEW_YAW in ``like``'s dtype: for float32 the
    float32 angle's float64 cos/sin rounded once, as XLA folds them."""
    a = float(torch.tensor(VIEW_YAW, dtype=like.dtype)) \
        if like.dtype == torch.float32 else VIEW_YAW
    c = torch.tensor(math.cos(a), dtype=like.dtype, device=like.device)
    s = torch.tensor(math.sin(a), dtype=like.dtype, device=like.device)
    return c, s


def _row(a, x, b, y):
    """``a*x + b*y``, contracted as ``fma(a, x, b*y)`` in float32."""
    return f32.fma(a, x, b * y)


def _row2(a, x, b, y):
    """``a*x + b*y``, contracted as ``fma(b, y, a*x)`` in float32."""
    return f32.fma(b, y, a * x)


def rot2d(theta: Tensor) -> Tensor:
    """Rotation matrices with shape ``theta.shape + (2, 2)``."""
    s, c = f32.sin_cos(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


def apply_rot(theta: Tensor, pts: Tensor) -> Tensor:
    """Rotate points ``pts[..., P, 2]`` by ``theta`` (no translation)."""
    s, c = f32.sin_cos(theta)
    c, s = c[..., None], s[..., None]
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack([_row2(c, x, -s, y), _row2(s, x, c, y)], -1)


def apply_se2(pose: Tensor, pts: Tensor) -> Tensor:
    """Apply ``pose=(x, y, theta)`` to points ``pts[..., P, 2]``;
    ``pose[..., :2]`` broadcasts against the leading dims of ``pts``."""
    return apply_rot(pose[..., 2], pts) + pose[..., None, :2]


def inv_se2(pose: Tensor) -> Tensor:
    """Inverse of an SE(2) pose triple."""
    s, c = f32.sin_cos(pose[..., 2])
    x, y = pose[..., 0], pose[..., 1]
    return torch.stack([-_row(c, x, s, y), -_row2(-s, x, c, y),
                        -pose[..., 2]], -1)


def world_to_base(pose: Tensor, pts_world: Tensor) -> Tensor:
    """Map world points ``[..., P, 2]`` into the frame of ``pose``."""
    return apply_rot(-pose[..., 2], pts_world - pose[..., None, :2])


def wrap_angle(a: Tensor) -> Tensor:
    """Wrap to (-pi, pi]."""
    s, c = f32.sin_cos(a)
    return torch.atan2(s, c)


def goal_in_base(pose: Tensor, goal_xy: Tensor):
    """Goal position expressed in the robot base frame (the reference's
    ``Agent::get_state``, agent.cpp:156-184): returns (bx, by)."""
    d = goal_xy - pose[..., :2]
    s, c = f32.sin_cos(pose[..., 2])
    return (_row(c, d[..., 0], s, d[..., 1]),
            _row2(-s, d[..., 0], c, d[..., 1]))


def base_to_view(pts_base: Tensor, half_extent: float) -> Tensor:
    """Base-frame points -> view frame, the reference's tf convention:
    ``view = R(-VIEW_YAW) @ base - R(-VIEW_YAW) @ (half, half)``.
    VIEW_YAW is *almost* pi, so this is about ``half - base`` with the
    ~2.65e-6 skew the reference also has."""
    c, s = _view_cs(pts_base)
    bx, by = pts_base[..., 0], pts_base[..., 1]
    h = torch.as_tensor(half_extent, dtype=pts_base.dtype,
                        device=pts_base.device)
    vx = _row(c, bx, s, by) - _row(c, h, s, h)
    vy = _row(-s, bx, c, by) - _row(-s, h, c, h)
    return torch.stack([vx, vy], -1)


def view_to_base(pts_view: Tensor, half_extent: float) -> Tensor:
    """View-frame points -> base frame: apply ``tf_view_base_``."""
    c, s = _view_cs(pts_view)
    vx, vy = pts_view[..., 0], pts_view[..., 1]
    return torch.stack([_row(c, vx, -s, vy) + half_extent,
                        _row(s, vx, c, vy) + half_extent], -1)
