"""Pedestrian two-leg gait model (torch port of ``img_env_tpu.crowd.gait``;
PedAgent, agent.cpp:653-735).

The 7-phase cycle advances with distance walked; phases place the legs at
base-frame offsets of 0, +-step_len/2, +-step_len along x.  Phase 7 is
unreachable (state % 7), so the reference's ``state==5 || state==7``
branch triggers only at 5, as the tables below encode.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from img_env_tpu_torch.constants import GAIT_PHASES, GAIT_STEP_LEN
from img_env_tpu_torch.ops.f32 import fma
from img_env_tpu_torch.ops.raster import div_const

# x-offset multipliers (in units of step_len) for (left, right) per phase.
# phases 0,4: configured rest offsets; 1,3: right leads by half; 2: full;
# 5: left leads by half; 6: left leads by full.
_LEFT_MULT = np.array([0.0, -0.5, -1.0, -0.5, 0.0, 0.5, 1.0], np.float32)
_RIGHT_MULT = np.array([0.0, 0.5, 1.0, 0.5, 0.0, -0.5, -1.0], np.float32)
_REST = np.array([1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0], np.float32)
_TABLES = {}


def _tables(device, dtype):
    """The phase tables on ``device``, copied there once."""
    key = (str(device), dtype)
    if key not in _TABLES:
        _TABLES[key] = tuple(torch.as_tensor(a, device=device, dtype=dtype)
                             for a in (_LEFT_MULT, _RIGHT_MULT, _REST))
    return _TABLES[key]


def update_gait(gait_state, gait_residual, move_dist, rest_left_xy,
                rest_right_xy
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance the gait cycle (PedAgent::update_bbox, agent.cpp:696-735).

    move_dist: [..., M] distance moved since the last step (any leading
    scene axes, as gait_state and gait_residual); rest_left_xy /
    rest_right_xy: [M,2] (or [..., M, 2]) configured leg offsets
    (sizes[0:2], [3:5]).  Returns (new_state [..., M] int32, new_residual
    [..., M], leg_offsets [..., M, 2, 2]).
    In float32 the step count divides by the float32 reciprocal and the
    residual is one fused multiply-add, as XLA compiles the JAX package.
    """
    total = move_dist + gait_residual
    steps = div_const(total, GAIT_STEP_LEN).to(torch.int32)
    new_state = steps + gait_state
    k = (new_state - gait_state).to(total.dtype)
    new_residual = fma(-k, torch.full_like(k, GAIT_STEP_LEN), total)
    new_state = torch.remainder(new_state, GAIT_PHASES)

    left_mult, right_mult, rest_phase = _tables(total.device, total.dtype)
    idx = new_state.long()
    lm = left_mult[idx] * GAIT_STEP_LEN
    rm = right_mult[idx] * GAIT_STEP_LEN
    rest = rest_phase[idx] > 0

    # Phases 0/4 restore the configured (x, y) rest offsets; the stride
    # phases overwrite only x and keep y, which is the configured y (the
    # reference never changes leg.y outside 0/4).
    shape = lm.shape
    left = torch.stack([torch.where(rest, rest_left_xy[..., 0], lm),
                        rest_left_xy[..., 1].expand(shape)], -1)
    right = torch.stack([torch.where(rest, rest_right_xy[..., 0], rm),
                         rest_right_xy[..., 1].expand(shape)], -1)
    return new_state, new_residual, torch.stack([left, right], dim=-2)
