"""BARN-style benchmark suite: evaluate a policy over a directory of worlds
(torch port of ``img_env_tpu.eval.barn`` and of ``examples/run_barn.py``).

The reference's BarnDataSetWrapper (evaluation_wrapper/BarnDataSetWrapper.py)
relaunches Gazebo for each of the 300 BARN worlds and logs per-world metrics
to CSV.  Here a "world" is an occupancy map image: the sequential suite
rebuilds the env per world and runs K episodes with the given policy; the
batched suite steps every world of a chunk as one scene batch.  Both write
the same style of per-world CSV.

    python -m img_env_tpu_torch.eval.barn --generate 300 --batched --mpc \\
        --chunk 100 --episodes 3 --max-steps 150

runs the protocol on the card (``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


def _write_csv(path: str, rows: List[dict]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def _world_cfg(base_cfg, world: str):
    return base_cfg.replace(
        map_file=os.path.basename(world),
        map_dir=os.path.dirname(os.path.abspath(world)) or base_cfg.map_dir)


def run_barn_suite(
    world_files: Sequence[str],
    base_cfg,
    policy_fn: Callable,            # (generator, obs_list) -> [N, act_dim]
    episodes_per_world: int = 3,
    max_steps: int = 200,
    output_csv: Optional[str] = None,
    output_txt: Optional[str] = None,
    seed: int = 0,
    device="cuda",
) -> List[dict]:
    """Returns per-world metric dicts; optionally writes a per-world CSV and
    the reference's per-episode log (BarnDataSetWrapper.out2logfile format:
    ``world, arrive, static_collision, stuck, v_avg, w_avg, v_acc, w_acc,
    v_jerk, w_jerk, w_zero, path_time, steps``).  ``policy_fn`` gets a
    ``torch.Generator`` seeded with the world's seed (``seed`` + its
    index) and the facade's observation."""
    from img_env_tpu_torch.env.gymapi import ImgNavEnv
    from img_env_tpu_torch.utils.trajectory import TrajectoryStats

    rows: List[dict] = []
    ep_lines: List[str] = []
    for wi, wf in enumerate(world_files):
        cfg = _world_cfg(base_cfg, wf)
        env = ImgNavEnv(cfg, seed=seed + wi, device=device)
        gen = torch.Generator(device=env.device).manual_seed(seed + wi)
        traj = TrajectoryStats(dt=float(cfg.control_hz))
        t0 = time.perf_counter()
        obs = env.reset()
        ep = 0
        steps = 0
        while ep < episodes_per_world and steps < max_steps * episodes_per_world:
            actions = policy_fn(gen, obs)
            obs, reward, done, info = env.step(actions)
            speeds = np.asarray(info["speeds"])
            traj.add_vw(speeds[0, 0], speeds[0, 1])   # robot 0, like the ref
            steps += 1
            if bool(np.asarray(info["all_down"])):
                ep += 1
                di = int(np.asarray(info["dones_info"]).reshape(-1)[0])
                md = traj.metric_dict()
                md.update(cur_world=os.path.basename(wf),
                          arrive=int(di == 5), static_collision=int(di == 1),
                          stuck=int(di == 10))
                ep_lines.append(
                    "{cur_world}, {arrive}, {static_collision}, {stuck}, "
                    "{v_avg}, {w_avg}, {v_acc}, {w_acc}, {v_jerk}, "
                    "{w_jerk}, {w_zero}, {path_time}, {steps}".format_map(md))
                traj.clear()
                if not env.stack.use_never_stop:
                    obs = env.reset()
        m = env.metrics.summary()
        row = {
            "world": os.path.basename(wf),
            "episodes": m["episodes"],
            "arrive_rate": m["arrive_rate"],
            "static_coll_rate": m["static_coll_rate"],
            "ped_coll_rate": m["ped_coll_rate"],
            "stuck_rate": m["stuck_rate"],
            "avg_v": m["avg_v"],
            "avg_w": m["avg_w"],
            "wall_s": round(time.perf_counter() - t0, 2),
        }
        rows.append(row)
        print(f"[barn] {row}")
    if output_csv and rows:
        _write_csv(output_csv, rows)
    if output_txt and ep_lines:
        # overwrite like the csv: re-running the suite must not mix runs
        # (the reference's BarnDataSetWrapper appends because each world is
        # a separate process; here one call covers the whole suite)
        os.makedirs(os.path.dirname(os.path.abspath(output_txt)),
                    exist_ok=True)
        with open(output_txt, "w") as f:
            f.write("\n".join(ep_lines) + "\n")
    return rows


def load_padded_maps(world_files: Sequence[str], base_cfg) -> np.ndarray:
    """Every world's base map at the view resolution, padded with occupied
    cells (0) to the largest shape: uint8 [S, H, W]."""
    from img_env_tpu_torch.env import maps as maps_mod

    loaded = [maps_mod.load_static_map(_world_cfg(base_cfg, w))
              for w in world_files]
    hm = max(m.shape[0] for m in loaded)
    wm = max(m.shape[1] for m in loaded)
    maps = np.zeros((len(loaded), hm, wm), np.uint8)   # pad = 0 (occupied)
    for i, m in enumerate(loaded):
        maps[i, : m.shape[0], : m.shape[1]] = m
    return maps


def run_barn_suite_batched(
    world_files: Sequence[str],
    base_cfg,
    policy_fn: Optional[Callable] = None,  # (generator, obs) -> [S, N, >=2]
    episodes_per_world: int = 3,
    max_steps: int = 200,
    output_csv: Optional[str] = None,
    seed: int = 0,
    mpc=None,                       # MppiConfig -> drive the MPC controller
    mpc_weights=None,               # CostWeights override (corridor tuning)
    chunk: int = 0,                 # >0: worlds per scene batch
    device="cuda",
) -> List[dict]:
    """Every world of a chunk steps in ONE scene batch (heterogeneous scene
    batching): the world maps are padded to a common shape (pad cells =
    occupied) and ride the scene axis of BatchedNavEnv via
    ``reset(..., static_maps=...)``.  With ``mpc`` one
    ``MpcController.act_scenes`` plans every world each step.  A world
    whose robots are all down (or whose episode reached ``max_steps``) is
    redrawn alone, its state carried over (``reset(carry=)``) and its MPC
    warm start cleared.  Returns the same per-world metric rows as
    ``run_barn_suite``; as in the reference, ``avg_v`` / ``avg_w`` are NaN
    on this path and chunk c0 runs with seed ``seed + c0`` (ROADMAP F9).
    """
    from img_env_tpu_torch.core.state import map_tree
    from img_env_tpu_torch.parallel.batched_env import BatchedNavEnv

    if chunk and len(world_files) > chunk:
        # protocol-scale runs (the reference's 300 BARN worlds,
        # BarnDataSetWrapper.py:32) in fixed-size scene batches
        rows: List[dict] = []
        for c0 in range(0, len(world_files), chunk):
            rows += run_barn_suite_batched(
                world_files[c0:c0 + chunk], base_cfg, policy_fn,
                episodes_per_world, max_steps, None, seed + c0, mpc=mpc,
                mpc_weights=mpc_weights, device=device)
        if output_csv and rows:
            _write_csv(output_csv, rows)
        return rows

    s = len(world_files)
    cfg = _world_cfg(base_cfg, world_files[0])
    maps = load_padded_maps(world_files, base_cfg)
    env = BatchedNavEnv(cfg, device, seed=seed)
    dev = env.device
    maps_t = torch.as_tensor(maps, device=dev)
    states, obs = env.reset(s, static_maps=maps_t)
    gen = torch.Generator(device=dev).manual_seed(seed)

    ctl = None
    if mpc is not None:
        from img_env_tpu_torch.mpc.controller import MpcController

        ctl = MpcController(env.core, mpc, weights=mpc_weights, seed=seed)
        mss = ctl.init_scenes_state(s)

    t0 = time.perf_counter()
    ep_done = np.zeros(s, np.int64)
    arrive = np.zeros(s, np.int64)
    s_coll = np.zeros(s, np.int64)
    p_coll = np.zeros(s, np.int64)
    stuck = np.zeros(s, np.int64)
    elapsed = np.zeros(s, np.int64)
    steps = 0
    while (ep_done < episodes_per_world).any() and steps < (
            max_steps * episodes_per_world * 2):
        if ctl is not None:
            actions, mss, _ = ctl.act_scenes(states, mss)
        else:
            actions = torch.as_tensor(policy_fn(gen, obs), device=dev,
                                      dtype=torch.float32)
        if actions.shape[-1] < 3:
            actions = torch.cat(
                [actions, actions.new_zeros(actions.shape[:-1] + (1,))], -1)
        states, obs, reward, done, info = env.step(states, actions)
        steps += 1
        elapsed += 1
        coll = obs.is_collisions.cpu().numpy()       # [S, N]
        arr = obs.is_arrives.cpu().numpy()
        # per-world episode end: every robot down, or per-world time limit
        down = ((np.clip(coll, 0, 1) + arr) > 0).all(axis=1)
        timeout = elapsed >= max_steps
        fin = (down | timeout) & (ep_done < episodes_per_world)
        if fin.any():
            idx = np.nonzero(fin)[0]
            for i in idx:
                ep_done[i] += 1
                arrive[i] += int(arr[i].all())
                s_coll[i] += int((coll[i] == 1).any())
                p_coll[i] += int((coll[i] == 2).any())
                stuck[i] += int(timeout[i] and not down[i])
            # re-draw the finished worlds (same per-world map), keep others
            sel = torch.as_tensor(idx, device=dev)
            pick = lambda x: x[sel]
            rstates, robs = env.reset(len(idx), carry=map_tree(pick, states),
                                      static_maps=maps_t[sel])
            put = lambda old, new: old.index_copy(0, sel, new)
            states = map_tree(put, states, rstates)
            obs = map_tree(put, obs, robs)
            if ctl is not None:   # fresh MPC warm-start for re-drawn worlds
                mss = map_tree(lambda x: x.index_fill(0, sel, 0.0), mss)
            elapsed[fin] = 0
    wall = time.perf_counter() - t0

    rows = []
    for i, wf in enumerate(world_files):
        e = max(int(ep_done[i]), 1)
        rows.append({
            "world": os.path.basename(wf),
            "episodes": int(ep_done[i]),
            "arrive_rate": arrive[i] / e,
            "static_coll_rate": s_coll[i] / e,
            "ped_coll_rate": p_coll[i] / e,
            "stuck_rate": stuck[i] / e,
            "avg_v": float("nan"),
            "avg_w": float("nan"),
            "wall_s": round(wall, 2),
        })
        print(f"[barn-batched] {rows[-1]}")
    if output_csv and rows:
        _write_csv(output_csv, rows)
    return rows


def straight_policy(generator, obs):
    """The straight-at-goal baseline of one world: 0.5 m/s, turning toward
    the goal (the facade's observation list: vector states second)."""
    vec = np.asarray(obs[1] if isinstance(obs, list) else
                     obs.vector_states.cpu()).reshape(-1)[-3:]
    w = float(np.clip(np.arctan2(vec[1], vec[0]), -0.9, 0.9))
    return np.asarray([[0.5, w]])


def straight_policy_batched(generator, obs):
    """``straight_policy`` over a scene batch's observation ([S, N, ...])."""
    vec = obs.vector_states.cpu().numpy()[..., -3:]          # [S,N,3]
    w = np.clip(np.arctan2(vec[..., 1], vec[..., 0]), -0.9, 0.9)
    return np.stack([np.full_like(w, 0.5), w], axis=-1)


def corridor_profile():
    """run_barn.py's MPC profile for BARN (run_barn.py:99-101): the
    geodesic goal field (global guidance, the move_base global plan of the
    reference's BARN runs) and a narrower static-safety band, so that
    sub-metre passages are traversable rather than cost-prohibitive."""
    from img_env_tpu_torch.mpc.cost import CostWeights
    from img_env_tpu_torch.mpc.mppi import MppiConfig

    return (MppiConfig(horizon=8, samples=64, goal_field=True),
            CostWeights(goal=6.0, terminal_goal=30.0, clearance=15.0,
                        safety_dist=0.25))


def main(argv=None) -> None:
    """The BARN benchmark driver (port of examples/run_barn.py)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worlds", default=None,
                    help="directory of world PNGs (default: shipped 3)")
    ap.add_argument("--generate", type=int, default=0,
                    help="generate N fresh worlds (seeds 0..N-1) into "
                         "OUT/worlds")
    ap.add_argument("--episodes", type=int, default=3)
    ap.add_argument("--max-steps", type=int, default=200)
    ap.add_argument("--out", default="barn_out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batched", action="store_true",
                    help="every world of a chunk in one scene batch "
                         "(padded maps on the scene axis)")
    ap.add_argument("--mpc", action="store_true",
                    help="drive the MPPI controller instead of the "
                         "straight-at-goal baseline (batched mode only)")
    ap.add_argument("--chunk", type=int, default=100,
                    help="worlds per scene batch in batched mode (0 = all)")
    args = ap.parse_args(argv)
    if args.mpc and not args.batched:
        raise SystemExit("--mpc needs --batched (the sequential suite "
                         "drives the straight-at-goal baseline only; "
                         "silently ignoring --mpc would mislabel the CSV)")

    from img_env_tpu_torch.config import EnvConfig
    from img_env_tpu_torch.datasets import barn

    if args.generate:
        worlds = barn.generate_worlds(os.path.join(args.out, "worlds"),
                                      n=args.generate)
    elif args.worlds:
        worlds = sorted(glob.glob(os.path.join(args.worlds, "*.png")))
    else:
        maps = os.path.join(os.path.dirname(barn.__file__), "..", "maps")
        worlds = [os.path.join(maps, f"barn_world_{i}.png") for i in range(3)]
    if not worlds:
        raise SystemExit("no worlds found")

    cfg = EnvConfig.from_dict(barn.world_cfg_dict(worlds[0]))
    t0 = time.perf_counter()
    if args.batched:
        mpc_cfg, mpc_w8 = corridor_profile() if args.mpc else (None, None)
        rows = run_barn_suite_batched(
            worlds, cfg, straight_policy_batched,
            episodes_per_world=args.episodes, max_steps=args.max_steps,
            mpc=mpc_cfg, mpc_weights=mpc_w8, chunk=args.chunk,
            output_csv=os.path.join(args.out, "barn_worlds.csv"),
            device=args.device)
    else:
        rows = run_barn_suite(
            worlds, cfg, straight_policy, episodes_per_world=args.episodes,
            max_steps=args.max_steps,
            output_csv=os.path.join(args.out, "barn_worlds.csv"),
            output_txt=os.path.join(args.out, "barn_episodes.txt"),
            device=args.device)
    wall = time.perf_counter() - t0
    episodes = sum(r["episodes"] for r in rows)
    arrived = sum(r["arrive_rate"] * r["episodes"] for r in rows)
    print(f"worlds={len(rows)} episodes={episodes} mean "
          f"arrive_rate={np.mean([r['arrive_rate'] for r in rows]):.4f} "
          f"arrive share {arrived / max(episodes, 1):.4f} wall "
          f"{wall:.1f} s -> {args.out}")


if __name__ == "__main__":
    main()
