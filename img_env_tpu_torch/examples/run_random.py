"""Random-policy smoke driver — the analogue of the reference env_test.py
(port of examples/run_random.py).

    python -m img_env_tpu_torch.examples.run_random [cfg.json] \
        [--episodes N] [--render out.png] [--device cpu]

Builds the env from a config (a yaml needs PyYAML), runs the same uniform
random policy as env_test.py:22-42 (v ~ U[0,0.6], w ~ U[-0.9,0.9]) and
prints the episode metrics.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


class RandomPolicy4Nav:
    def __init__(self, n: int, v_range=(0.0, 0.6), w_range=(-0.9, 0.9),
                 seed=0, n_discrete: int = 0):
        self.n = n
        self.v_range, self.w_range = v_range, w_range
        self.rng = np.random.default_rng(seed)
        self.n_discrete = n_discrete

    def gen_action(self):
        if self.n_discrete:
            return self.rng.integers(0, self.n_discrete, self.n)
        v = self.rng.uniform(*self.v_range, self.n)
        w = self.rng.uniform(*self.w_range, self.n)
        return np.stack([v, w], axis=-1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cfg", nargs="?", default=None)
    ap.add_argument("--episodes", type=int, default=5)
    ap.add_argument("--max-steps", type=int, default=200)
    ap.add_argument("--render", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from img_env_tpu_torch.config import EnvConfig
    from img_env_tpu_torch.env.gymapi import make_env

    env = make_env(args.cfg or EnvConfig(), device=args.device)
    policy = RandomPolicy4Nav(
        env.robot_total,
        n_discrete=len(env.cfg.discrete_actions) if env.cfg.discrete_action
        else 0)
    env.reset()
    t0 = time.perf_counter()
    steps, episodes = 0, 0
    while episodes < args.episodes:
        _, _, _, info = env.step(policy.gen_action())
        steps += 1
        if bool(info["all_down"]) or steps % args.max_steps == 0:
            episodes += 1
            if not env.stack.use_never_stop:
                env.reset()
    dt = time.perf_counter() - t0
    print(f"{steps} steps / {episodes} episodes in {dt:.2f}s "
          f"({steps * env.robot_total / dt:.0f} robot-steps/s)")
    print("metrics:", env.metrics.summary())

    if args.render:
        from img_env_tpu_torch.eval.render import render_frame, save_png

        save_png(args.render, render_frame(env.state, env.core.statics))
        print("wrote", args.render)


if __name__ == "__main__":
    main()
