"""The beeping MPPI actor: the ``mppi`` actor (``actors/mppi.py``), whose
commands then take a beep column: 1 where the robot's ``ped_min_dists``
in the last observation is below the configuration's ``beep_r`` (1.0 m:
the threshold of ``bool_get_close_to_human``, ``env/wrappers.py:114``),
else 0.  The rule runs on the card; nothing is read back for it.

Traffic keys: those of ``mppi``.  The reference's side is ``mppi``'s
with ``reference/mpc/orca_head.py``'s controller (the reference
controller's, with the 'orca' head besides) and the same rule applied to
the reference's own observation: it compares the commands (with the beep
column), the nominal plan and the costs.
"""

import os

import torch

from navbench import check
from navbench.parts import load_part
from navbench.reference.mpc import orca_head

_mppi = load_part(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "actors", "mppi")


def beeping(actions, ped_min_dists, beep_r: float):
    """``actions`` [..., 3] with the beep column set: 1 where
    ``ped_min_dists`` [...] is below ``beep_r``, else 0."""
    beep = (ped_min_dists < beep_r).to(actions.dtype)
    return torch.cat([actions[..., :2], beep[..., None]], -1)


class Actor(_mppi.Actor):
    def act(self, keep: bool):
        lp = self.loop
        actions, aux = super().act(keep)
        return beeping(actions, lp.obs.ped_min_dists,
                       float(lp.env_cfg.beep_r)), aux


class _BeepRule:
    """A reference controller whose commands take the beep rule on the
    distances ``dists`` the check sets before each call."""

    def __init__(self, ctl, beep_r: float):
        self.ctl, self.beep_r, self.dists = ctl, beep_r, None

    def act(self, *args):
        actions, ms, costs = self.ctl.act(*args)
        return beeping(actions, self.dists, self.beep_r), ms, costs

    def act_scenes(self, *args):
        actions, ms, costs = self.ctl.act_scenes(*args)
        return beeping(actions, self.dists, self.beep_r), ms, costs


class Check(_mppi.Check):
    def __init__(self, replay):
        replay.ref.controller = orca_head
        super().__init__(replay)
        self.ctl = _BeepRule(self.ctl, float(replay.cfg.beep_r))

    def compare(self, rd, state, obs, rec):
        self.ctl.dists = check.lower(obs, self.replay.control).ped_min_dists
        super().compare(rd, state, obs, rec)
