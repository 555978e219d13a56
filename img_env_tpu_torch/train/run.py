"""PPO training over the scene batch — the port of
``examples/train_ppo.py``.

    python -m img_env_tpu_torch.train.run [CFG] [--scenes 8] [--updates 20]
        [--unroll 16] [--lr 3e-4] [--epochs 2] [--minibatches 2]
        [--reward-scale 1.0] [--sigma0 -0.5] [--force-sigma S]
        [--ent-coef 0.01] [--curve PREFIX] [--save FILE] [--restore FILE]
        [--seed 0] [--device cuda] [--procs N] [--backend gloo|nccl]

CFG is an env config as ``.json`` (the dict of a reference yaml, as
``img_env_tpu_torch/artifacts/stage5_policy_env.json`` stores it) or as
``.yaml`` where PyYAML is installed; without one, a small room with
``--robots`` robots and ``--peds`` ORCA peds in fast sensor mode.  The run
is on the card unless ``--device cpu``.  ``--restore`` warm-starts from the
port's checkpoint (``--save`` writes one: ``{"params": ...}`` through
``train/checkpoint.py``) or from a JAX-exported npz
(``tools/export_policy_npz.py``); ``--force-sigma`` then overrides
``pi_log_std``.  Every 5 updates it prints the loss, reward, arrive and
collision rates, entropy and robot-steps/s; ``--curve PREFIX`` writes
``PREFIX.csv`` (update, reward_mean, arrive_rate, collision_rate).

The run is under a [scene, model] mesh, as ``examples/train_ppo.py``'s:
one rank by default (a world of one), ``--procs N`` ranks spawned on this
host, or the ranks of torch's launcher (its ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``).  The ``--scenes`` shard over the
ranks, which draw alike (``parallel/batched_env.py``) and sum their
gradients; rank 0 prints and saves.  ``--backend gloo`` lets several
ranks share one card (NCCL refuses that).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.models.policy import (PolicyConfig, init_policy,
                                             policy_params_from_numpy)
from img_env_tpu_torch.parallel import distributed
from img_env_tpu_torch.parallel.batched_env import BatchedNavEnv
from img_env_tpu_torch.parallel.mesh import make_mesh
from img_env_tpu_torch.train import checkpoint as ckpt_mod
from img_env_tpu_torch.train.ppo import PpoConfig, make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m img_env_tpu_torch.train.run",
        description="PPO training of CrowdNavPolicy over a scene batch")
    ap.add_argument("cfg", nargs="?", default=None,
                    help="env config (.json, or .yaml with PyYAML)")
    ap.add_argument("--scenes", type=int, default=8)
    ap.add_argument("--updates", type=int, default=20)
    ap.add_argument("--unroll", type=int, default=16)
    ap.add_argument("--robots", type=int, default=2)
    ap.add_argument("--peds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--minibatches", type=int, default=2)
    ap.add_argument("--reward-scale", type=float, default=1.0,
                    help="scale rewards entering GAE (paper rewards span "
                         "+-500; 0.02 keeps the value loss in range)")
    ap.add_argument("--sigma0", type=float, default=-0.5,
                    help="initial log-std of the Gaussian policy head")
    ap.add_argument("--force-sigma", type=float, default=None,
                    help="override pi_log_std after --restore")
    ap.add_argument("--ent-coef", type=float, default=0.01)
    ap.add_argument("--curve", default=None, help="write PREFIX.csv")
    ap.add_argument("--save", default=None,
                    help="checkpoint file for the trained params")
    ap.add_argument("--restore", default=None,
                    help="warm-start params from a checkpoint file or a "
                         "JAX-exported .npz")
    ap.add_argument("--procs", type=int, default=1,
                    help="ranks to spawn on this host (scenes shard over "
                         "them)")
    ap.add_argument("--backend", default=None,
                    help="process group backend (default: nccl with a card "
                         "per rank, else gloo)")
    return ap.parse_args(argv)


def load_config(path: Optional[str], robots: int = 2,
                peds: int = 2) -> EnvConfig:
    if path is None:
        return EnvConfig.from_dict({
            "robot": {
                "total": robots,
                "begin_poses_type": ["range"],
                "begin_poses": [[1.0, 9.0, 1.0, 9.0]],
                "target_poses_type": ["range"],
                "target_poses": [[1.0, 9.0, 1.0, 9.0]],
            },
            "ped_sim": {
                "total": peds, "type": "rvoscene", "max_speed": [0.5],
                "begin_poses_type": ["range"],
                "begin_poses": [[1.0, 9.0, 1.0, 9.0]],
                "target_poses_type": ["range"],
                "target_poses": [[1.0, 9.0, 1.0, 9.0]],
            },
            "global_map": {"map_file": "room_10.png", "resolution": 0.1},
            "view_map": {"resolution": 0.03, "width": 6.0, "height": 6.0},
            "range_total": 128,
            "max_ped": max(peds, 1),
            "sensor_mode": "fast",
        })
    return EnvConfig.from_yaml(path)


def restore_params(path: str, params: dict) -> dict:
    """``params`` replaced by a checkpoint's or a JAX-exported npz's, with
    their names and shapes checked."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return ckpt_mod.conform(
                policy_params_from_numpy({k: z[k] for k in z.files}), params)
    # read on the CPU; ``like`` moves each tensor to its parameter's device
    return ckpt_mod.restore(path, like={"params": params},
                            device="cpu")["params"]


def train(args: argparse.Namespace, cfg: Optional[EnvConfig] = None,
          log: Callable[[str], None] = print) -> dict:
    """The training run of ``args`` (``cfg`` in place of ``args.cfg``)
    under a mesh of the process group's ranks (``make_mesh``: a world of
    one unless ranks were started).  Returns {"history": rows of (update,
    reward_mean, arrive_rate, collision_rate), "metrics": each update's
    metrics (device scalars), "timings": each update's host seconds of its
    rollout, autoreset and update, "ts", "states", "obs", "env", "model",
    "train_step", "generator"}."""
    cfg = cfg or load_config(args.cfg, args.robots, args.peds)
    dev = torch.device(args.device)
    mesh = make_mesh(device_type=dev.type)
    env = BatchedNavEnv(cfg, dev, seed=args.seed + 1, mesh=mesh)
    pcfg = dataclasses.replace(PolicyConfig.from_env_config(cfg),
                               log_std_init=args.sigma0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model, params = init_policy(gen, pcfg, dev)
    if args.restore:
        params = restore_params(args.restore, params)
        log(f"warm-started params from {args.restore}")
    if args.force_sigma is not None:
        params["pi_log_std"] = torch.full_like(params["pi_log_std"],
                                               args.force_sigma)
        log(f"pi_log_std forced to {args.force_sigma}")

    init_fn, train_step = make_train_step(
        env, model, PpoConfig(unroll=args.unroll, lr=args.lr,
                              epochs=args.epochs,
                              minibatches=args.minibatches,
                              ent_coef=args.ent_coef,
                              reward_scale=args.reward_scale))
    ts = init_fn(params)
    states, obs = env.reset(args.scenes)
    gen.manual_seed(args.seed + 2)
    history, timings, metrics = [], [], []
    n_rob = cfg.robot.total
    t0 = time.perf_counter()
    last_u, last_t = 0, t0
    for u in range(args.updates):
        tim = {}
        ts, states, obs, m = train_step(ts, states, obs, gen, timings=tim)
        timings.append(tim)
        metrics.append(m)
        history.append((u + 1, m["reward_mean"], m["arrive_rate"],
                        m["collision_rate"]))
        if (u + 1) % 5 == 0 or u == 0:
            loss = float(m["loss"])
            now = time.perf_counter()
            sps = ((u + 1 - last_u) * args.unroll * args.scenes * n_rob
                   / (now - last_t))
            last_u, last_t = u + 1, now
            log(f"update {u + 1:4d}  loss {loss:9.4f}  "
                f"reward {float(m['reward_mean']):8.3f}  "
                f"arrive {float(m['arrive_rate']):5.2f}  "
                f"collide {float(m['collision_rate']):5.2f}  "
                f"entropy {float(m['entropy']):6.3f}  "
                f"{sps:8.0f} robot-steps/s")

    h = np.asarray([[float(v) for v in row] for row in history])
    k = max(len(h) // 5, 1)
    log(f"reward first-{k} mean {h[:k, 1].mean():.3f} -> "
        f"last-{k} mean {h[-k:, 1].mean():.3f}; "
        f"arrive {h[:k, 2].mean():.2f} -> {h[-k:, 2].mean():.2f}")
    if args.save and dist.get_rank() == 0:
        ckpt_mod.save(args.save, {"params": ts.params})
        log(f"saved params checkpoint to {args.save}")
    if args.curve and dist.get_rank() == 0:
        np.savetxt(args.curve + ".csv", h, delimiter=",", comments="",
                   header="update,reward_mean,arrive_rate,collision_rate")
        log(f"wrote {args.curve}.csv")
    return {"history": h, "metrics": metrics, "timings": timings, "ts": ts,
            "states": states, "obs": obs, "env": env, "model": model,
            "train_step": train_step, "generator": gen}


def rank_main(argv) -> None:
    """One of ``--procs`` spawned ranks: the run, printed by rank 0."""
    args = parse_args(argv)
    train(args, log=print if dist.get_rank() == 0 else lambda s: None)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.procs > 1:
        runs = distributed.spawn("img_env_tpu_torch.train.run:rank_main",
                                 args.procs, [argv], backend=args.backend)
        sys.stdout.write("".join(
            line + "\n" for line in runs[0].out.splitlines()
            if not line.startswith(distributed.RESULT)))
        failed = [(k, r) for k, r in enumerate(runs) if r.rc]
        for k, r in failed:
            sys.stderr.write(f"--- rank {k} rc {r.rc}\n{r.err}")
        if failed:
            raise SystemExit(1)
    else:
        distributed.initialize(backend=args.backend)
        try:
            train(args, log=print if not dist.is_initialized()
                  or dist.get_rank() == 0 else lambda s: None)
        finally:
            if dist.is_initialized():    # train's world of one, or ranks'
                dist.destroy_process_group()
    print("done")


if __name__ == "__main__":
    main()
