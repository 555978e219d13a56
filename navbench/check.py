"""The correctness check's parts: the frozen plain reference
(``navbench/reference``) loaded by name, the comparison of the program's
outputs with the reference's, the control precisions, and the judgement
against a cell's limits.  Each loop's ``Reference`` (``envloop.py`` for
the env loops) replays the steps that the window drove with them.

The reference follows the program step by step: each compared step starts
from a copy of the program's own state (its previous output), taken as the
window ran, with the same commands and MPPI noise; the reset that starts
the run is compared by itself, from the same episode layouts.  The
reference builds its own tables from the configuration and loads the
policy's weights from the same raw file; it takes nothing else from the
program.  Each compared number is the largest difference over the compared
steps; a cell's check file (``navbench/checks/<cell>.json``) gives each
number its limit.

``control`` runs the reference in the nearest precision below the
configuration's float32: 'tf32' (TF32 matmuls and convolutions) or 'bf16'
(the reference's float32 inputs rounded to bfloat16).  Only the control
tests and ``navbench/control.py`` use it.
"""

from __future__ import annotations

import contextlib
import importlib
import json

import numpy as np
import torch

from navbench.drive import tmap

REF_TYPES = ("core.state", "mpc.controller", "env.sampler")


def load_reference():
    """The reference's modules, by short name."""
    mods = {}
    for name in ("config", "core.state", "env.nav_env",
                 "env.sampler", "mpc.controller", "mpc.mppi",
                 "models.policy"):
        mods[name] = importlib.import_module("navbench.reference." + name)
    ns = type("Ref", (), {})()
    ns.config = mods["config"]
    ns.sampler = mods["env.sampler"]
    ns.nav_env = mods["env.nav_env"]
    ns.state = mods["core.state"]
    ns.controller = mods["mpc.controller"]
    ns.mppi = mods["mpc.mppi"]
    ns.policy = mods["models.policy"]
    ns.types = {}
    for name in REF_TYPES:
        for attr, obj in vars(mods[name]).items():
            if isinstance(obj, type) and hasattr(obj, "_fields"):
                ns.types.setdefault(attr, obj)
    return ns


def to_ref(ref, tree):
    """A program's NamedTuple tree as the reference's own types (matched by
    class name), tensors shared."""
    if tree is None or isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = ref.types[type(tree).__name__]
        return cls(*(to_ref(ref, x) for x in tree))
    return tree


@contextlib.contextmanager
def precision(ref, control):
    """The reference's precision: float32 with TF32 off (the
    configuration's), or the 'tf32' control."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, mm.allow_tf32, ref.policy.full_float32)
    on = control == "tf32"
    cudnn.allow_tf32 = mm.allow_tf32 = on
    if on:
        ref.policy.full_float32 = contextlib.nullcontext
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32, ref.policy.full_float32 = saved


def lower(tree, control):
    """The reference's inputs for the 'bf16' control: every float32 tensor
    rounded to bfloat16."""
    if control != "bf16":
        return tree
    return tmap(lambda x: (x.to(torch.bfloat16).to(torch.float32)
                           if x.dtype == torch.float32 else x), tree)


def gap(a, b) -> float:
    """Largest |a - b| (equal infinities count as 0); shapes must agree."""
    a, b = a.detach(), b.detach()
    if a.shape != b.shape:
        return float("inf")
    if a.dtype == torch.bool or not a.is_floating_point():
        return float((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
            if a.numel() else 0.0
    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def mismatch(a, b) -> float:
    a, b = (torch.as_tensor(np.asarray(x.cpu() if isinstance(x, torch.Tensor)
                                       else x)) for x in (a, b))
    if a.shape != b.shape:
        return float("inf")
    return float((a.to(torch.int64) != b.to(torch.int64)).sum())


class Readings:
    """The largest reading of each compared number."""

    def __init__(self):
        self.values = {}

    def put(self, name: str, value: float) -> None:
        self.values[name] = max(self.values.get(name, 0.0), float(value))


def compare_env(rd: Readings, prog_state, prog_obs, ref_state, ref_obs,
                peds: bool) -> None:
    """The env's outputs: kinematics, codes, sensor maps, lasers, vector
    states and, with peds, the ped state and the ped observation."""
    pr, rr = prog_state.robots, ref_state.robots
    rd.put("kinematics", max(gap(getattr(pr, f), getattr(rr, f))
                             for f in ("pose", "vw_last0", "vw_last1",
                                       "vel_world")))
    rd.put("codes", sum(mismatch(getattr(pr, f), getattr(rr, f))
                        for f in ("collision", "arrive"))
           + sum(mismatch(getattr(prog_obs, f), getattr(ref_obs, f))
                 for f in ("is_collisions", "is_arrives")))
    rd.put("sensor_maps", gap(prog_obs.sensor_maps, ref_obs.sensor_maps))
    rd.put("lasers", max(gap(prog_obs.lasers, ref_obs.lasers),
                         gap(prog_obs.angular_maps, ref_obs.angular_maps)))
    rd.put("vector_states", max(gap(prog_obs.vector_states,
                                     ref_obs.vector_states),
                                gap(prog_obs.step_ds, ref_obs.step_ds)))
    if peds:
        pp, rp = prog_state.peds, ref_state.peds
        rd.put("peds", max(gap(getattr(pp, f), getattr(rp, f))
                           for f in ("pos", "vel", "yaw", "leg_offset")))
        rd.put("ped_obs", max(gap(getattr(prog_obs, f), getattr(ref_obs, f))
                              for f in ("ped_maps", "ped_vector_states",
                                        "ped_min_dists")))


def load_limits(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)["limits"]


def judge(values: dict, limits: dict):
    """(correct, [(name, reading, limit)]): every number of ``limits``
    must be read and lie at or under its limit."""
    rows = [(name, values.get(name, float("inf")), float(limit))
            for name, limit in limits.items()]
    return all(v <= lim for _, v, lim in rows), rows
