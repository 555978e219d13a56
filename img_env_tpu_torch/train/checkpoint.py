"""Checkpoints of a training run (torch port of
``img_env_tpu.train.checkpoint``).

The format is the port's own: ``torch.save`` of a nested dict of tensors,
read back with ``weights_only=True`` (no code runs on load).  A tree may
hold dicts, lists, tuples, NamedTuples (a ``TrainState``, a ``WorldState``,
an optimizer state), tensors, numbers, strings and None; NamedTuples are
stored as dicts of their fields, and ``restore(like=...)`` rebuilds them.
A generator's state is a tensor (``generator.get_state()``).  The card has
no orbax: the JAX package's checkpoints cross as the flat npz of
``tools/export_policy_npz.py`` (``models.policy.load_policy_npz``).
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch


def _plain(tree):
    """NamedTuples as dicts of their fields, tensors detached."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach()
    return tree


def conform(tree, like):
    """``tree`` (dicts in place of NamedTuples, as ``save`` stores them) in
    ``like``'s structure, each tensor checked against ``like``'s shape and
    given its dtype and device."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(conform(tree[f], getattr(like, f))
                            for f in like._fields))
    if isinstance(like, dict):
        if set(tree) != set(like):
            raise ValueError(f"checkpoint keys {sorted(tree)} != "
                             f"{sorted(like)}")
        return {k: conform(tree[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if len(tree) != len(like):
            raise ValueError("checkpoint sequence length differs")
        return type(like)(conform(t, v) for t, v in zip(tree, like))
    if torch.is_tensor(like):
        if tuple(tree.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint shape {tuple(tree.shape)} != "
                             f"{tuple(like.shape)}")
        return tree.to(device=like.device, dtype=like.dtype)
    return tree


def save(path: str, tree: Any) -> None:
    """Write a checkpoint of ``tree`` (a TrainState, a WorldState, a dict
    of them, ...) to the file ``path``."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(_plain(tree), path)


def restore(path: str, like: Optional[Any] = None, device="cuda") -> Any:
    """Read a checkpoint onto ``device`` (the card by default).  Without
    ``like``: the stored tree (NamedTuples as dicts).  With ``like``: that
    structure, every tensor checked against its shape and given its dtype
    and device."""
    tree = torch.load(os.path.abspath(path), map_location=device,
                      weights_only=True)
    return tree if like is None else conform(tree, like)


def save_every(step: int, interval: int, path: str, tree: Any) -> bool:
    """Checkpoint to ``{path}-{step}`` when ``step`` crosses an interval
    boundary; returns True when a checkpoint was written."""
    if interval <= 0 or step % interval:
        return False
    save(f"{path}-{step}", tree)
    return True
