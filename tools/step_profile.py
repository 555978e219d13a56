"""Device time per control step at bench200, bench200ped, bench200ervo and
bench200 with ``paint_mode='block'`` (the gen-1 painter, K5), on one
NVIDIA GPU, for the tree at ``--tree``.

    python3 tools/step_profile.py --tree DIR [--steps 5] [--out FILE]
                                  [--plain-rotations]

Imports ``img_env_tpu_torch`` and ``chip_smoke`` from ``DIR``, so two
checkouts (e.g. a commit and its parent unpacked with ``git archive``) can
be compared in one call, in turns.  The control steps are the tree's own
``chip_smoke.run_path`` (reset, 3 warm-up steps, then ``--steps`` steps of
MPPI act and env step; at bench200ervo the even robots beep).  Per cell it
runs twice: once for the host ms per step (run_path's own clock, ending in
a synchronize), and once with torch.profiler started at the first timed
step's act, which gives the device operations, the device busy time (the
sum of the device events' durations on the one stream) and the device
time per step of K1-K5 (their kernels by name, before and after each
redesign) and of the step's memsets (K1's memset design cleared its map
with one).  The profiled window also holds run_path's final checksum
test (a few operations).  Prints one JSON line; with ``--out``
also writes it there.

``--plain-rotations`` swaps the step's float32-bit emulation of the
robot kinematics, the vector states and the goal distances (the
``ops/f32`` forms that give the JAX package's CPU bits) for plain torch
arithmetic, on the same tree, so that the two runs differ in those
operations alone (the final arrival distance keeps its ``ops/f32`` form).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

KERNELS = {
    "K1": ("raster_robots_kernel", "clear_map_kernel"),
    "K2": ("fill_sorted_kernel", "occupancy_bits_kernel", "fill_bits_kernel"),
    "K3": ("paint_rows_kernel", "paint_slots_kernel"),
    "K4": ("pedmap_kernel",),
    "K5": ("paint_blocks_kernel",),
    "memset": ("Memset",),
}
WARMUP = 3


def plain_rotations() -> None:
    """The step's kinematics, vector states and goal distances in plain
    torch arithmetic (torch's own sin/cos, sqrt and rounding)."""
    import functools

    import torch
    from img_env_tpu_torch.constants import ARRIVE_DIST, SUBSTEP_DT
    from img_env_tpu_torch.dynamics import kinematics
    from img_env_tpu_torch.env import observe

    def substep_arrival(pose, goal, v, w, v_y, n_substeps, omni):
        x, y, th = pose[:, 0], pose[:, 1], pose[:, 2]
        vx, vy = torch.zeros_like(x), torch.zeros_like(x)
        arrived = torch.zeros_like(x, dtype=torch.bool)
        for _ in range(n_substeps):
            c, s = torch.cos(th), torch.sin(th)
            nx = x + v * SUBSTEP_DT * c
            ny = y + v * SUBSTEP_DT * s
            if omni:
                nx = nx - v_y * SUBSTEP_DT * s
                ny = ny + v_y * SUBSTEP_DT * c
                nvx, nvy = vx, vy
            else:
                nvx, nvy = v * c, v * s
            d = torch.sqrt((nx - goal[:, 0]) ** 2 + (ny - goal[:, 1]) ** 2)
            keep = ~arrived
            x, y = torch.where(keep, nx, x), torch.where(keep, ny, y)
            th = torch.where(keep, th + w * SUBSTEP_DT, th)
            vx, vy = torch.where(keep, nvx, vx), torch.where(keep, nvy, vy)
            arrived = arrived | (d <= ARRIVE_DIST)
        return torch.stack([vx, vy], dim=-1), arrived

    def vector_state(pose, goal_xy, goal_yaw, vw_last0, state_dim):
        d = goal_xy - pose[:, :2]
        c, s = torch.cos(pose[:, 2]), torch.sin(pose[:, 2])
        dyaw = goal_yaw - pose[:, 2]
        bx, by = c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]
        yaw = torch.atan2(torch.sin(dyaw), torch.cos(dyaw))
        v, w = vw_last0[:, 0], vw_last0[:, 1]
        return torch.stack({3: [bx, by, yaw], 4: [bx, by, v, w],
                            5: [bx, by, yaw, v, w]}[state_dim], -1)

    kinematics._substep_arrival = substep_arrival
    kinematics._exact_pose_update = functools.partial(
        kinematics._exact_pose_update, xla_bits=False)
    observe.vector_state = vector_state
    observe.goal_distances = lambda vec: torch.sqrt(
        vec[:, 0] ** 2 + vec[:, 1] ** 2)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--plain-rotations", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    if args.plain_rotations:
        plain_rotations()

    import torch

    if not torch.cuda.is_available():
        sys.exit("step_profile: no CUDA device")
    import chip_smoke as cs
    from img_env_tpu_torch import EnvConfig, MpcController, MppiConfig, NavEnv

    def profiled(env, ctl, **kw):
        """The device events of run_path's timed steps."""
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        act, calls = ctl.act, [0]

        def act_from_first_timed_step(*a, **k):
            calls[0] += 1
            if calls[0] == WARMUP + 1:
                torch.cuda.synchronize()
                prof.start()
            return act(*a, **k)

        ctl.act = act_from_first_timed_step
        try:
            cs.run_path(env, ctl, WARMUP, args.steps, (), **kw)
        finally:
            del ctl.act
            prof.stop()
        return [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    out = {"tree": args.tree, "card": card,
           "plain_rotations": args.plain_rotations, "cells": {}}
    for name, cfg, kw in (
            ("bench200", cs.BENCH200, {}),
            ("bench200ped", cs.BENCH200PED, {"crowd": True}),
            ("bench200ervo", cs.BENCH200ERVO, {"crowd": True, "beep": True}),
            ("bench200 paint_mode=block", dict(cs.BENCH200, paint_mode="block"),
             {})):
        env = NavEnv(EnvConfig.from_dict(cfg), "cuda")
        ctl = MpcController(env, MppiConfig(horizon=cs.H, samples=cs.K))
        host_ms = cs.run_path(env, ctl, WARMUP, args.steps, (), **kw).ms_step
        dev = profiled(env, ctl, **kw)
        us = lambda evs: sum(e.time_range.elapsed_us() for e in evs)
        per_step = lambda names: us(
            [e for e in dev if any(k in e.name for k in names)]
        ) / 1e3 / args.steps
        cell = {"ms_per_step_host": host_ms,
                "device_ops_per_step": len(dev) / args.steps,
                "device_busy_ms_per_step": us(dev) / 1e3 / args.steps,
                "kernel_ms_per_step": {k: per_step(names)
                                       for k, names in KERNELS.items()}}
        out["cells"][name] = cell
        cs.log(f"# {args.tree} {name}: {cell}")
        del env, ctl
        torch.cuda.empty_cache()
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
