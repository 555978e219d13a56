"""Failures per seed of chosen BARN worlds, the port against the JAX package,
on the CPU.

    JAX_PLATFORMS=cpu python tools/barn_worlds_check.py --impl torch
        [--worlds 63,64,88,91] [--seeds 0,1,2,3,4] [--episodes 3]
        [--max-steps 150] [--out FILE]

Generates BARN worlds 0..max(worlds) with the port's generator (the same
PNGs as the JAX package's, ``tests/test_torch_barn.py``), then runs the
batched suite with run_barn.py's corridor MPC profile (goal-field MPPI,
H=8, K=64) over the chosen worlds as one scene batch, once per seed:
``--impl torch`` through ``img_env_tpu_torch.eval.barn`` on the CPU,
``--impl jax`` through ``img_env_tpu.eval.barn`` (imports JAX).  Prints
one JSON line: for each seed, each world's episodes, arrivals, static
collisions and stuck episodes, and the wall seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("torch", "jax"), required=True)
    ap.add_argument("--worlds", default="63,64,88,91")
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--episodes", type=int, default=3)
    ap.add_argument("--max-steps", type=int, default=150)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    worlds = [int(w) for w in args.worlds.split(",")]
    seeds = [int(s) for s in args.seeds.split(",")]

    from img_env_tpu_torch.datasets import barn as tbarn

    tmp = tempfile.mkdtemp(prefix="barn_worlds_")
    files = tbarn.generate_worlds(tmp, n=max(worlds) + 1)
    files = [files[w] for w in worlds]
    cfg_dict = tbarn.world_cfg_dict(files[0])

    if args.impl == "torch":
        import torch

        torch.set_num_threads(args.threads)
        from img_env_tpu_torch.config import EnvConfig
        from img_env_tpu_torch.eval import barn

        mpc, weights = barn.corridor_profile()
        run = lambda seed: barn.run_barn_suite_batched(
            files, EnvConfig.from_dict(cfg_dict), None,
            episodes_per_world=args.episodes, max_steps=args.max_steps,
            seed=seed, mpc=mpc, mpc_weights=weights, device="cpu")
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from img_env_tpu.config import EnvConfig
        from img_env_tpu.eval import barn
        from img_env_tpu.mpc import MppiConfig
        from img_env_tpu.mpc.cost import CostWeights

        # examples/run_barn.py's corridor profile
        mpc = MppiConfig(horizon=8, samples=64, goal_field=True)
        weights = CostWeights(goal=6.0, terminal_goal=30.0, clearance=15.0,
                              safety_dist=0.25)
        run = lambda seed: barn.run_barn_suite_batched(
            files, EnvConfig.from_dict(cfg_dict), None,
            episodes_per_world=args.episodes, max_steps=args.max_steps,
            seed=seed, mpc=mpc, mpc_weights=weights)

    out = {"impl": args.impl, "worlds": worlds, "episodes": args.episodes,
           "max_steps": args.max_steps, "seeds": {}}
    for seed in seeds:
        t0 = time.perf_counter()
        rows = run(seed)
        out["seeds"][seed] = {
            "wall_s": time.perf_counter() - t0,
            "per_world": {
                w: {"episodes": r["episodes"],
                    "arrive": round(r["arrive_rate"] * r["episodes"]),
                    "static_coll": round(r["static_coll_rate"]
                                         * r["episodes"]),
                    "stuck": round(r["stuck_rate"] * r["episodes"])}
                for w, r in zip(worlds, rows)}}
        print(json.dumps({seed: out["seeds"][seed]}), flush=True)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
