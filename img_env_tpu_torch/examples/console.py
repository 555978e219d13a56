"""Interactive debug console — the DRLConsole analogue (comn_pkg/src/
drl_console.cpp:16-76, wired-but-disabled in the reference); port of
examples/console.py.

    python -m img_env_tpu_torch.examples.console [cfg.json] [--device cpu]

Commands:
    reset [seed]        new episode
    step [v w]          step all robots with (v, w) (default 0.3 0.0)
    peek robots|peds|obs   print state slices
    render [file.png]   write a frame
    metrics             episode metrics so far
    quit
"""

from __future__ import annotations

import argparse
import shlex

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cfg", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from img_env_tpu_torch.config import EnvConfig
    from img_env_tpu_torch.env.gymapi import ImgNavEnv

    cfg = EnvConfig.from_yaml(args.cfg) if args.cfg else EnvConfig()
    env = ImgNavEnv(cfg, device=args.device)
    env.reset()
    print(f"env up: {cfg.robot.total} robots, {cfg.ped_sim.total} peds. "
          f"type 'help' for commands.")

    while True:
        try:
            line = input("img_env> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not line:
            continue
        cmd, *rest = shlex.split(line)
        if cmd in ("quit", "exit", "q"):
            break
        elif cmd == "help":
            print(__doc__)
        elif cmd == "reset":
            env.core.generator.manual_seed(int(rest[0]) if rest else 0)
            env.reset()
            print("reset ok")
        elif cmd == "step":
            v = float(rest[0]) if rest else 0.3
            w = float(rest[1]) if len(rest) > 1 else 0.0
            acts = np.tile([v, w], (env.robot_total, 1))
            _, reward, done, info = env.step(acts)
            print(f"reward={np.round(reward, 2)} done={done} "
                  f"dones_info={info['dones_info']}")
        elif cmd == "peek":
            st = env.state
            what = rest[0] if rest else "robots"
            if what == "robots":
                print("pose:\n", np.round(st.robots.pose.cpu().numpy(), 3))
                print("goal:\n", np.round(st.robots.goal.cpu().numpy(), 3))
                print("collision:", st.robots.collision.cpu().numpy(),
                      "arrive:", st.robots.arrive.cpu().numpy())
            elif what == "peds":
                print("pos:\n", np.round(st.peds.pos.cpu().numpy(), 3))
                print("vel:\n", np.round(st.peds.vel.cpu().numpy(), 3))
            else:
                m = st.obs_map.cpu().numpy()
                print(f"obs_map {m.shape}, occupied cells: {(m < 250).sum()}")
        elif cmd == "render":
            from img_env_tpu_torch.eval.render import render_frame, save_png

            out = rest[0] if rest else "img_env_frame.png"
            save_png(out, render_frame(env.state, env.core.statics))
            print("wrote", out)
        elif cmd == "metrics":
            print(env.metrics.summary())
        else:
            print(f"unknown command {cmd!r}; try 'help'")


if __name__ == "__main__":
    main()
