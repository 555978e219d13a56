"""ERVO beep evacuation demo (IROS-21 story): peds scatter from a beeping
robot and ignore a silent one (port of examples/ervo_beep_demo.py).

    python -m img_env_tpu_torch.eval.ervo_beep_demo [--out beep_demo.png]

Two identical ERVO crowds (8 peds ringed around the robot, goals at the
ring center so they'd otherwise converge): left panel robot silent, right
panel robot beeping every step (v_y=1, ped_ca_p=1).  The trajectories are
the full env step path — beep sampling (img_env.cpp:323-342), the ERVO
evacuation term (ervoscene.h:13-22, Agent.cpp:63-69) — not the solver in
isolation.  The figure needs matplotlib; ``--out ''`` prints the
distances only.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

M = 8


def demo_cfg():
    """One robot at the centre of a ring of 8 ERVO peds heading for it."""
    from img_env_tpu_torch.config import EnvConfig

    m = M
    ring = [[5 + 1.6 * math.cos(2 * math.pi * i / m),
             5 + 1.6 * math.sin(2 * math.pi * i / m),
             0.0] for i in range(m)]
    center = [[5.0, 5.0, 0.0]] * m
    return EnvConfig.from_dict({
        "env_name": "beepdemo", "control_hz": 0.4, "act_dim": 3,
        "ped_ca_p": 1.0, "beep_r": 2.0,
        "robot": {"total": 1, "shape": ["circle"], "size": [[0, 0, 0.17]],
                  "begin_poses_type": ["fix"], "begin_poses": [[5.0, 5.0, 0.0]],
                  "target_poses_type": ["fix"], "target_poses": [[9.0, 5.0, 0.0]]},
        "object": {"total": 0},
        "ped_sim": {"total": m, "type": "ervoscene", "max_speed": [0.5],
                    "shape": ["circle"], "size": [[0, 0, 0.17]],
                    "begin_poses_type": ["fix"] * m, "begin_poses": ring,
                    "target_poses_type": ["fix"] * m, "target_poses": center,
                    "go_back": "no"},
        "global_map": {"map_file": "room_10.png", "resolution": 0.1},
        "view_map": {"resolution": 0.05, "width": 6.0, "height": 6.0},
        "range_total": 64, "max_ped": m, "state_dim": 3,
        "sensor_mode": "fast",
    })


def rollout(env, beep: float, steps: int):
    """Ped positions [steps + 1, M, 2] of one episode with the robot
    standing still, beeping or not, and the beeps fired."""
    state, _ = env.reset()
    acts = torch.tensor([[0.0, 0.0, beep]], device=env.device)
    traj = [state.peds.pos.cpu().numpy()]
    beeps = 0
    for _ in range(steps):
        state, obs, r, d, info = env.step(state, acts)
        beeps += int(info["beeps"].sum())
        traj.append(state.peds.pos.cpu().numpy())
    return np.stack(traj), beeps


def draw(out: str, silent, beeping, beep_r: float) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d_sil = np.linalg.norm(silent[-1] - [5, 5], axis=-1)
    d_bee = np.linalg.norm(beeping[-1] - [5, 5], axis=-1)
    fig, axes = plt.subplots(1, 2, figsize=(9, 4.4), sharex=True, sharey=True)
    for ax, traj, title, dm in (
            (axes[0], silent, "silent robot", d_sil.mean()),
            (axes[1], beeping, f"beeping robot (r={beep_r} m)",
             d_bee.mean())):
        for p in range(M):
            ax.plot(traj[:, p, 0], traj[:, p, 1], "-", lw=1.2,
                    color="tab:green", alpha=0.8)
            ax.plot(traj[0, p, 0], traj[0, p, 1], "o", ms=4,
                    color="tab:green")
            ax.plot(traj[-1, p, 0], traj[-1, p, 1], "s", ms=4,
                    color="darkgreen")
        c = plt.Circle((5, 5), beep_r, fill=False, ls="--",
                       color="tab:red" if "beep" in title else "gray")
        ax.add_patch(c)
        ax.plot([5], [5], "*", ms=14, color="tab:blue")
        ax.set_title(f"{title}\nmean final dist {dm:.2f} m")
        ax.set_aspect("equal")
        ax.set_xlim(2.2, 7.8)
        ax.set_ylim(2.2, 7.8)
    fig.suptitle("ERVO evacuation: peds converge on a silent robot, "
                 "scatter from a beeping one (full env path)")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    fig.savefig(out, dpi=110)
    plt.close(fig)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="ervo_beep_demo.png")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from img_env_tpu_torch.env.nav_env import NavEnv

    cfg = demo_cfg()
    env = NavEnv(cfg, args.device)
    silent, b0 = rollout(env, 0.0, args.steps)
    beeping, b1 = rollout(env, 1.0, args.steps)
    if b0 != 0 or b1 != args.steps:
        raise AssertionError(f"beeps fired: silent {b0}, beeping {b1}")
    d_sil = np.linalg.norm(silent[-1] - [5, 5], axis=-1)
    d_bee = np.linalg.norm(beeping[-1] - [5, 5], axis=-1)
    print(f"final mean dist to robot: silent {d_sil.mean():.2f} m, "
          f"beeping {d_bee.mean():.2f} m ({b1} beeps fired)")
    if args.out:
        draw(args.out, silent, beeping, cfg.beep_r)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
