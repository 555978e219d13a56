"""PPO learning curves from scratch on easy_train's config (README.md:101-104's
settings: ``chip_smoke.EASY_TRAIN`` and ``chip_smoke.EASY_ARGS``), one run
per seed, and the card against the CPU on injected draws.

    python3 tools/train_curves.py [--seeds 0,1,2] [--updates 150]
                                  [--device cuda] [--track N] [--out FILE]

For each seed, ``img_env_tpu_torch.train.run.train`` with ``EASY_ARGS``
(that seed, ``--updates``) on ``--device``; prints the first-10 and
last-10 means of reward_mean and the mean of each 10 updates.  The card's
runs are not bit-reproducible (cuDNN's backward), so a seed there is one
draw of its outcome.  ``--track N`` runs instead N updates on the card and
on the CPU from one CPU-drawn init, the same layouts, Gaussian draws and
permutations (``ppo.Draws``), and prints each update's reward_mean,
arrive and collision rates and scenes reset on both: the two agree until
rounding flips an episode, then drift apart.  ``--out`` writes the
curves as JSON.  The JAX package's runs of the same settings are
``examples/train_ppo.py img_env_tpu/configs/easy_train.yaml --cpu
--scenes 16 --unroll 16 --lr 3e-4 --reward-scale 0.02 --sigma0 -1.0``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from img_env_tpu_torch import BatchedNavEnv, EnvConfig  # noqa: E402
from img_env_tpu_torch.models.policy import (CrowdNavPolicy,  # noqa: E402
                                             PolicyConfig, init_policy)
from img_env_tpu_torch.train import ppo, run  # noqa: E402


def by_10(h):
    return [round(float(h[i:i + 10].mean()), 3) for i in range(0, len(h), 10)]


def curves(seeds, updates: int, device: str) -> dict:
    out = {}
    for seed in seeds:
        args = list(cs.EASY_ARGS)
        args[args.index("--seed") + 1] = str(seed)
        args[args.index("--updates") + 1] = str(updates)
        t0 = time.perf_counter()
        res = run.train(run.parse_args(args + ["--device", device]),
                        cfg=EnvConfig.from_dict(cs.EASY_TRAIN),
                        log=lambda s: None)
        h = res["history"][:, 1]
        out[seed] = h.tolist()
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s, first-10 "
              f"{h[:10].mean():.3f}, last-10 {h[-10:].mean():.3f}, by 10 "
              f"{by_10(h)}", flush=True)
    return out


def track(updates: int, device: str) -> dict:
    cfg = EnvConfig.from_dict(cs.EASY_TRAIN)
    a = run.parse_args(cs.EASY_ARGS)
    s, t = a.scenes, a.unroll
    pc = ppo.PpoConfig(unroll=t, lr=a.lr, epochs=a.epochs,
                       minibatches=a.minibatches, ent_coef=a.ent_coef,
                       reward_scale=a.reward_scale)
    pol = dataclasses.replace(PolicyConfig.from_env_config(cfg),
                              log_std_init=a.sigma0)
    gen = torch.Generator().manual_seed(a.seed)
    _, params0 = init_policy(gen, pol, "cpu")
    env_c = BatchedNavEnv(cfg, "cpu")
    first = [env_c.core.sample_scenario() for _ in range(s)]
    draws = [ppo.Draws(torch.randn((t, s * cfg.robot.total, cfg.act_dim),
                                   generator=gen),
                       [env_c.core.sample_scenario() for _ in range(s)],
                       torch.stack([torch.randperm(t * s * cfg.robot.total,
                                                   generator=gen)
                                    for _ in range(pc.epochs)]))
             for _ in range(updates)]
    rows = {}
    for dev in (device, "cpu"):
        env = env_c if dev == "cpu" else BatchedNavEnv(cfg, dev)
        init_fn, step = ppo.make_train_step(
            env, CrowdNavPolicy(pol).to(dev), pc)
        ts = init_fn({k: v.to(dev) for k, v in params0.items()})
        states, obs = env.reset([cs.to_device(x, dev) for x in first])
        rows[dev] = []
        for d in draws:
            d = ppo.Draws(d.eps.to(dev),
                          [cs.to_device(x, dev) for x in d.reset],
                          d.perms.to(dev))
            ts, states, obs, m = step(ts, states, obs, None, d)
            rows[dev].append([float(m["reward_mean"]),
                              float(m["arrive_rate"]),
                              float(m["collision_rate"]),
                              int(m["reset_scenes"])])
    for u in range(updates):
        print(f"update {u + 1}: {device} {rows[device][u]}, cpu "
              f"{rows['cpu'][u]}", flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--updates", type=int, default=150)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--track", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    # torch's default TF32 flags, as a user's run would have them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    if args.track:
        res = track(args.track, args.device)
    else:
        res = curves([int(x) for x in args.seeds.split(",")], args.updates,
                     args.device)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(res, f)


if __name__ == "__main__":
    main()
