"""Multi-process dryrun: the multi-host path, exercised for real (the port
of ``examples/distributed_dryrun.py``).

Spawns N ranks on this machine, each joining one ``torch.distributed``
job (``parallel/distributed.spawn``): the same code path a cluster uses,
with localhost standing in for the fleet.  Every rank:

  1. initializes and checks the world size,
  2. builds the global [scene, model] mesh over all ranks
     (``distributed.global_mesh``: rank-major scene blocks),
  3. assembles a scene-sharded batch of the scenes' seeds from its
     process-local block with ``process_local_batch`` and draws its
     scenes' layouts from them,
  4. runs an env reset and one PPO update on its scenes, the gradients
     summed across the ranks,
  5. checks the loss is finite and identical on every rank.

    python -m img_env_tpu_torch.parallel.dryrun [--procs 2] [--device cpu]
        [--backend gloo]

``--device cuda`` with more ranks than cards needs ``--backend gloo``.
"""

from __future__ import annotations

import argparse
import sys

SCENES_PER_PROC = 2


def tiny_cfg_dict(robots: int = 1, peds: int = 0) -> dict:
    """tests/test_parallel.py's tiny config: ``robots`` robots and ``peds``
    ORCA peds in the empty 10 m room, 6 m views at 0.05 m, 32 beams."""
    return {
        "robot": {
            "total": robots,
            "size": [[0.0, 0.0, 0.17]],
            "begin_poses_type": ["range"],
            "begin_poses": [[1.0, 9.0, 1.0, 9.0]],
            "target_poses_type": ["range"],
            "target_poses": [[1.0, 9.0, 1.0, 9.0]],
        },
        "ped_sim": {
            "total": peds, "type": "rvoscene", "max_speed": [0.5],
            "shape": ["circle"], "size": [[0.0, 0.0, 0.17]],
            "begin_poses_type": ["range"],
            "begin_poses": [[1.0, 9.0, 1.0, 9.0]],
            "target_poses_type": ["range"],
            "target_poses": [[1.0, 9.0, 1.0, 9.0]],
        },
        "global_map": {"map_file": "room_10.png", "resolution": 0.1},
        "view_map": {"resolution": 0.05, "width": 6.0, "height": 6.0},
        "range_total": 32,
        "max_ped": max(peds, 1),
    }


def worker(device: str) -> float:
    """One rank of the dryrun; returns its loss."""
    import torch
    import torch.distributed as dist

    from img_env_tpu_torch.config import EnvConfig
    from img_env_tpu_torch.env.sampler import sample_scenario_retry
    from img_env_tpu_torch.models.policy import PolicyConfig, init_policy
    from img_env_tpu_torch.parallel import distributed
    from img_env_tpu_torch.parallel.batched_env import BatchedNavEnv
    from img_env_tpu_torch.train.ppo import PpoConfig, make_train_step

    rank, nproc = dist.get_rank(), dist.get_world_size()
    dev = torch.device(device)
    s_global = nproc * SCENES_PER_PROC
    mesh = distributed.global_mesh(scene=nproc, model=1,
                                   device_type=dev.type)
    if mesh.size(0) != nproc:
        raise AssertionError(f"mesh {mesh.shape} over {nproc} ranks")
    cfg = EnvConfig.from_dict(tiny_cfg_dict(robots=1, peds=1))
    env = BatchedNavEnv(cfg, dev, seed=0, mesh=mesh)

    # process-local scene seeds -> one scene-sharded batch -> this rank's
    # layouts
    blk = env.block(s_global)
    local = torch.arange(s_global, dtype=torch.int64, device=dev)[blk]
    seeds = distributed.process_local_batch(mesh, (s_global,), local)
    spec = env.core.statics.sampler
    samples = [sample_scenario_retry(
        spec, torch.Generator(device=dev).manual_seed(int(k)), dev)
        for k in seeds.to_local().tolist()]
    states, obs = env.reset_local(samples)

    gen = torch.Generator(device=dev).manual_seed(0)
    model, params = init_policy(gen, PolicyConfig.from_env_config(cfg), dev)
    init_fn, train_step = make_train_step(env, model, PpoConfig(unroll=2))
    ts, states, obs, metrics = train_step(init_fn(params), states, obs,
                                          gen.manual_seed(7))
    loss = metrics["loss"].reshape(1)
    if not bool(torch.isfinite(loss).all()):
        raise AssertionError(f"loss {float(loss)}")
    first = loss.clone()
    dist.broadcast(first, src=0)
    if not torch.equal(first, loss):
        raise AssertionError(f"rank {rank}: loss {float(loss)} != rank "
                             f"0's {float(first)}")
    print(f"[proc {rank}] ok: ranks={nproc} scenes={s_global} "
          f"loss={float(loss):.4f} (agrees on {nproc} processes)",
          flush=True)
    return float(loss)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m img_env_tpu_torch.parallel.dryrun",
        description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="process group backend (default: nccl with a card "
                         "per rank, else gloo)")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)

    from img_env_tpu_torch.parallel.distributed import spawn

    runs = spawn("img_env_tpu_torch.parallel.dryrun:worker", args.procs,
                 [args.device], backend=args.backend,
                 timeout_s=args.timeout)
    for r in runs:
        sys.stdout.write(r.out)
    if any(r.rc for r in runs):
        for rank, r in enumerate(runs):
            if r.rc:
                sys.stdout.write(f"--- rank {rank} rc {r.rc}\n{r.err}")
        print("FAILED:", [r.rc for r in runs])
        return 1
    print(f"distributed dryrun ok: {args.procs} processes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
