"""MPC navigation demo: the MPPI (or iLQR) controller driving robots in the
env (port of examples/run_mpc.py).

    python -m img_env_tpu_torch.examples.run_mpc [cfg.json] [--steps N] \
        [--render out.png [--watch K]] [--gui] [--device cpu]

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def default_cfg(robots: int):
    """``robots`` robots and 2 RVO peds in room_10, 6 m views at 0.05 m,
    128 beams."""
    from img_env_tpu_torch.config import EnvConfig

    return EnvConfig.from_dict({
        "robot": {
            "total": robots,
            "begin_poses_type": ["range"],
            "begin_poses": [[1.0, 9.0, 1.0, 9.0]],
            "target_poses_type": ["range"],
            "target_poses": [[1.0, 9.0, 1.0, 9.0]],
        },
        "ped_sim": {
            "total": 2, "type": "rvoscene", "max_speed": [0.5],
            "begin_poses_type": ["range"],
            "begin_poses": [[1.0, 9.0, 1.0, 9.0]],
            "target_poses_type": ["range"],
            "target_poses": [[1.0, 9.0, 1.0, 9.0]],
        },
        "global_map": {"map_file": "room_10.png", "resolution": 0.1},
        "view_map": {"resolution": 0.05, "width": 6.0, "height": 6.0},
        "range_total": 128,
        "max_ped": 2,
    })


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cfg", nargs="?", default=None)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--robots", type=int, default=4)
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--method", default="mppi", choices=["mppi", "ilqr"])
    ap.add_argument("--pred", default="cv", choices=["cv", "orca", "sfm"],
                    help="pedestrian prediction head")
    ap.add_argument("--render", default=None)
    ap.add_argument("--watch", type=int, default=0, metavar="K",
                    help="re-render --render every K steps (live show_gui"
                         " flavor: watch the PNG in an image viewer)")
    ap.add_argument("--gui", action="store_true",
                    help="live show_gui window (map + goal labels + view"
                         " tiles), cv2/matplotlib backend auto-picked")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from img_env_tpu_torch.config import EnvConfig
    from img_env_tpu_torch.env.nav_env import NavEnv
    from img_env_tpu_torch.eval.render import render_frame, save_png
    from img_env_tpu_torch.mpc import MpcController, MppiConfig

    cfg = (EnvConfig.from_yaml(args.cfg) if args.cfg
           else default_cfg(args.robots))
    env = NavEnv(cfg, args.device)
    ctl = MpcController(env, MppiConfig(
        horizon=args.horizon, samples=args.samples), method=args.method,
        ped_prediction=args.pred)

    state, obs = env.reset()
    mstate = ctl.init_state()
    viewer = None
    if args.gui:
        from img_env_tpu_torch.eval.live_view import LiveViewer

        viewer = LiveViewer(env.statics, cfg)
        viewer.update(state, obs.sensor_maps)

    def goal_dists(st):
        return (st.robots.goal - st.robots.pose[:, :2]).norm(dim=-1) \
            .cpu().numpy()

    d0 = float(goal_dists(state).mean())
    t0 = time.perf_counter()
    for t in range(args.steps):
        actions, mstate, _ = ctl.act(state, mstate)
        state, obs, reward, done, info = env.step(state, actions)
        if (t + 1) % 10 == 0:
            print(f"step {t+1}: goal dists {np.round(goal_dists(state), 2)} "
                  f"arrive={state.robots.arrive.int().cpu().numpy()} "
                  f"coll={state.robots.collision.cpu().numpy()}")
        if viewer is not None:
            viewer.update(state, obs.sensor_maps)
        if args.watch and args.render and (t + 1) % args.watch == 0:
            save_png(args.render, render_frame(state, env.statics))
    dt = time.perf_counter() - t0
    d1 = float(goal_dists(state).mean())
    arr = int(state.robots.arrive.sum())
    print(f"{args.steps} steps in {dt:.2f}s ({dt/args.steps*1e3:.1f} "
          f"ms/step); mean goal dist {d0:.2f} -> {d1:.2f}; arrived "
          f"{arr}/{cfg.robot.total}; collisions "
          f"{state.robots.collision.cpu().tolist()}")
    if args.render:
        save_png(args.render, render_frame(state, env.statics))
        print("wrote", args.render)


if __name__ == "__main__":
    main()
