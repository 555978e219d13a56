"""World states to and from plain numpy arrays.

This is how a state crosses between the JAX package and the port: the JAX
side turns its pytree into numpy (``np.asarray`` on every leaf), and
``world_state_from_numpy`` builds the torch twin from any object with the
same field names.  The JAX ``rng`` key is dropped (the port draws from its
environment's ``torch.Generator``); the reset's ORCA segments
(``obstacles.segs``, None outside the ORCA crowds) cross with the rest.
"""

from __future__ import annotations

import numpy as np
import torch

from img_env_tpu_torch.core.state import (
    CrowdAuxState,
    ObstacleState,
    PedState,
    RobotState,
    WorldState,
)
from img_env_tpu_torch.crowd.orca import Segments

_GROUPS = (("robots", RobotState), ("peds", PedState),
           ("crowd_aux", CrowdAuxState))
_TOP = ("obs_map", "obs_edt", "step", "prev_goal_dist", "has_prev_dist")
_OBSTACLE = ("pose", "size", "is_circle", "aabb")


def _t(x, device):
    return torch.as_tensor(np.array(x, copy=True), device=device)


def world_state_from_numpy(tree, device="cpu") -> WorldState:
    parts = {name: cls(**{f: _t(getattr(getattr(tree, name), f), device)
                          for f in cls._fields})
             for name, cls in _GROUPS}
    obs = tree.obstacles
    segs = getattr(obs, "segs", None)
    parts["obstacles"] = ObstacleState(
        **{f: _t(getattr(obs, f), device) for f in _OBSTACLE},
        segs=None if segs is None else Segments(
            *(_t(getattr(segs, f), device) for f in Segments._fields)))
    parts.update({f: _t(getattr(tree, f), device) for f in _TOP})
    return WorldState(**parts)


def world_state_to_numpy(state: WorldState) -> WorldState:
    """The same NamedTuple tree with every tensor as a numpy array."""
    cvt = lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) else x
    return WorldState(
        robots=RobotState(*map(cvt, state.robots)),
        peds=PedState(*map(cvt, state.peds)),
        crowd_aux=CrowdAuxState(*map(cvt, state.crowd_aux)),
        obstacles=ObstacleState(
            *map(cvt, state.obstacles[:4]),
            segs=(None if state.obstacles.segs is None
                  else Segments(*map(cvt, state.obstacles.segs)))),
        **{f: cvt(getattr(state, f)) for f in _TOP})
