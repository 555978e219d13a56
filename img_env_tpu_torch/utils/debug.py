"""Numeric debugging helpers (torch port of ``img_env_tpu.utils.debug``).

The reference has no sanitizers; the useful mode here is NaN/Inf
trapping.  torch has no global switch like ``jax_debug_nans``, so
``nan_debug`` enters a ``TorchDispatchMode`` that checks the floating
outputs of every operator run inside it.  XLA's trap checks a jitted
program's outputs, where the port's sensor pass keeps Inf sentinels in its
intermediates: an Inf is trapped where an operator makes it from finite
arguments.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _finite(x) -> bool:
    """Whether an operator argument (a tensor or a number) holds no NaN or
    Inf."""
    if isinstance(x, torch.Tensor):
        return (not (x.is_floating_point() or x.is_complex())
                or bool(torch.isfinite(x).all()))
    if isinstance(x, (float, complex)):
        return math.isfinite(abs(x))
    return True


class _NanTrap(TorchDispatchMode):
    """Raises ``FloatingPointError`` naming the first operator whose
    floating or complex output holds a NaN, or an Inf that its arguments
    did not hold (an overflow or a division by zero; an Inf sentinel, such
    as ``torch.full(..., inf)`` or a min over one, passes)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in tree_leaves(out):
            if not isinstance(x, torch.Tensor) or _finite(x):
                continue
            if bool(torch.isnan(x).any()) or all(
                    _finite(a) for a in tree_leaves((args, kwargs))):
                raise FloatingPointError(
                    f"{func} produced a NaN or Inf (output of shape "
                    f"{tuple(x.shape)})")
        return out


@contextmanager
def nan_debug(enable: bool = True):
    """Trap NaNs and Infs produced by any torch operator in the block
    (``_NanTrap``).  It checks every output on the host, so on a card it
    syncs at each operator: for debugging only.

        with nan_debug():
            state, obs, *_ = env.step(state, actions)
    """
    if not enable:
        yield
        return
    with _NanTrap():
        yield
