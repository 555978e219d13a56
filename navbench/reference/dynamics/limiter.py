"""Velocity / acceleration / jerk command limiting (torch port of
``img_env_tpu.dynamics.limiter``).

Branch-free re-expression of the ros_controllers-style SpeedLimiter the
reference applies to each command axis independently (speed_limit.cpp:92-173,
invoked from agent.cpp:188-195), including the asymmetric same-sign /
sign-crossing acceleration handling.  As in the JAX package, jerk limits use
the configured min/max jerk (the reference's msg constructor assigns
``max_jerk = msg.min_jerk``, speed_limit.cpp:56-65; no shipped config
enables jerk limits).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from navbench.reference.config import SpeedLimiterConfig
from navbench.reference.ops.raster import div_const


class LimiterParams(NamedTuple):
    """Limiter parameters as Python scalars (static per config)."""

    has_velocity: bool
    has_acceleration: bool
    has_jerk: bool
    min_velocity: float
    max_velocity: float
    min_acceleration: float
    max_acceleration: float
    min_jerk: float
    max_jerk: float

    @staticmethod
    def from_config(cfg: SpeedLimiterConfig) -> "LimiterParams":
        return LimiterParams(
            bool(cfg.has_velocity_limits), bool(cfg.has_acceleration_limits),
            bool(cfg.has_jerk_limits), float(cfg.min_velocity),
            float(cfg.max_velocity), float(cfg.min_acceleration),
            float(cfg.max_acceleration), float(cfg.min_jerk),
            float(cfg.max_jerk))


def _f32(x: float, dt: float = None) -> float:
    """The JAX package keeps limiter params as float32 arrays, and a param
    times the Python ``dt`` is a float32 product; reproduce both roundings
    so float64 commands see identical bounds."""
    v = np.float32(x)
    return float(v if dt is None else v * np.float32(dt))


def _sign(x):
    # C++ sign(): 0 for exactly 0, else +-1 (speed_limit.cpp:49-53)
    return torch.where(x == 0, torch.zeros_like(x), torch.sign(x))


def _limit_jerk(p: LimiterParams, v, v0, v1, dt):
    dv, dv0 = v - v0, v0 - v1
    dt2 = 2.0 * dt * dt
    da = torch.clamp(dv - dv0, _f32(p.min_jerk, dt2), _f32(p.max_jerk, dt2))
    return v0 + dv0 + da


def _limit_acceleration(p: LimiterParams, v, v0, dt):
    amin, amax = _f32(p.min_acceleration), _f32(p.max_acceleration)
    v_sign, v0_sign = _sign(v), _sign(v0)
    dv_min = _f32(p.min_acceleration, dt)
    dv_max = _f32(p.max_acceleration, dt)
    dv = v - v0
    dv_sign = _sign(dv)

    # same-sign (or touching zero) branch (speed_limit.cpp:123-134)
    same_dir = (dv_sign == v0_sign) | (dv_sign == v_sign)
    dv_a = dv_sign * torch.clamp(torch.abs(dv), dv_min, dv_max)
    dv_b = dv_sign * torch.abs(torch.clamp(-torch.abs(dv), dv_min, dv_max))
    v_same = v0 + torch.where(same_dir, dv_a, dv_b)

    # sign-crossing branch (speed_limit.cpp:135-148)
    # XLA compiles the division by a constant into a product with its
    # float32 reciprocal (raster.div_const)
    zero_dt = torch.abs(div_const(v0, amin))
    v_dt = torch.abs(div_const(v, amax))
    v_decel = v0_sign * (torch.abs(v0) - _f32(abs(amin), dt))
    v_accel = v_sign * torch.abs(amax * (dt - zero_dt))
    v_cross = torch.where(zero_dt >= dt, v_decel,
                          torch.where(zero_dt + v_dt >= dt, v_accel, v))
    return torch.where(v_sign + v0_sign != 0, v_same, v_cross)


def limit_command(p: LimiterParams, v, v0, v1, dt: float):
    """Full limit chain: jerk -> acceleration -> velocity
    (speed_limit.cpp:92-101)."""
    if p.has_jerk:
        v = _limit_jerk(p, v, v0, v1, dt)
    if p.has_acceleration:
        v = _limit_acceleration(p, v, v0, dt)
    if p.has_velocity:
        v = torch.clamp(v, _f32(p.min_velocity), _f32(p.max_velocity))
    return v
