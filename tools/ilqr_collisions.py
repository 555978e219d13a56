"""Collision codes of the iLQR controller, the port against the JAX package,
at a cut of bench200 on the CPU.

    JAX_PLATFORMS=cpu python tools/ilqr_collisions.py [--robots 50]
        [--steps 7] [--out FILE]

bench200's room, robots and obstacles (chip_smoke.BENCH200) cut to
``--robots`` robots and as many obstacles, with 3 m views and 96 beams (the
planner reads neither).  From one JAX reset, the JAX package's
``MpcController(method='ilqr')`` and ``method='mppi'`` (its own draws) and
the port's iLQR (it draws nothing) each run ``--steps`` control steps;
prints one JSON line with every step's count of robots at collision codes
0-3 and the final mean goal distance of each.  Imports JAX and runs on
the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--robots", type=int, default=50)
    ap.add_argument("--steps", type=int, default=7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    import chip_smoke
    from img_env_tpu.config import EnvConfig as JaxEnvConfig
    from img_env_tpu.env.nav_env import NavEnv as JaxNavEnv
    from img_env_tpu.mpc import mppi as jmppi
    from img_env_tpu.mpc.controller import MpcController as JaxMpc
    from img_env_tpu_torch.config import EnvConfig
    from img_env_tpu_torch.core.convert import world_state_from_numpy
    from img_env_tpu_torch.env.nav_env import NavEnv
    from img_env_tpu_torch.mpc.controller import MpcController
    from img_env_tpu_torch.mpc.mppi import MppiConfig

    d = dict(chip_smoke.BENCH200,
             robot=dict(chip_smoke.BENCH200["robot"], total=args.robots),
             object=dict(chip_smoke.BENCH200["object"], total=args.robots),
             view_map={"resolution": 0.05, "width": 3.0, "height": 3.0},
             range_total=96)
    out = {"robots": args.robots, "steps": args.steps}
    with jax.enable_x64(False):
        env = JaxNavEnv(JaxEnvConfig.from_dict(d))
        state0, _ = env.reset(jax.random.PRNGKey(0))
        for method in ("ilqr", "mppi"):
            ctl = JaxMpc(env, jmppi.MppiConfig(horizon=12, samples=128),
                         method=method)
            act = jax.jit(ctl.act_fn)
            st, ms, codes = state0, ctl.init_state(), []
            for t in range(args.steps):
                a, ms, _ = act(jax.random.PRNGKey(t), st, ms)
                st, *_ = env.step(st, a)
                codes.append(np.bincount(np.asarray(st.robots.collision),
                                         minlength=4).tolist())
            out[f"jax {method}"] = dict(codes=codes, goal_d=float(
                np.linalg.norm(np.asarray(st.robots.goal
                                          - st.robots.pose[:, :2]),
                               axis=-1).mean()))
    env_t = NavEnv(EnvConfig.from_dict(d), "cpu")
    ctl = MpcController(env_t, MppiConfig(horizon=12, samples=128),
                        method="ilqr")
    st = world_state_from_numpy(jax.tree_util.tree_map(np.asarray, state0))
    ms, codes = ctl.init_state(), []
    for _ in range(args.steps):
        a, ms, _ = ctl.act(st, ms)
        st, *_ = env_t.step(st, a)
        codes.append(torch.bincount(st.robots.collision.long(),
                                    minlength=4).tolist())
    out["port ilqr"] = dict(codes=codes, goal_d=float(
        (st.robots.goal - st.robots.pose[:, :2]).norm(dim=-1).mean()))
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
