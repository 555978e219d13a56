"""Multi-process mesh initialization (torch port of
``img_env_tpu.parallel.distributed``).

The reference scales across machines by launching more ROS masters; here
one ``torch.distributed`` job owns every process and the same [scene,
model] mesh spans all of them.  Each process steps its own block of the
scenes; the trainer's reductions are ``all_reduce`` and ``broadcast``
only, the two collectives that gloo takes on CUDA tensors.

Usage in each process (or set the env vars of torch's launcher):

    from img_env_tpu_torch.parallel.distributed import initialize, global_mesh
    initialize("localhost:29500", 2, rank)   # False when single-process
    mesh = global_mesh(model=1, device_type="cuda")

or from one process, ``spawn("module:function", n, args)`` runs
``function(*args)`` as ranks 0..n-1 of a process group on this host.
"""

from __future__ import annotations

import datetime
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from img_env_tpu_torch.parallel.mesh import (DEFAULT_TIMEOUT_S, make_mesh,
                                             scene_sharding)


def _env_address() -> Optional[str]:
    """The coordinator's host:port from the env: the JAX package's
    ``COORDINATOR_ADDRESS``, else torch's ``MASTER_ADDR`` and
    ``MASTER_PORT``."""
    if os.environ.get("COORDINATOR_ADDRESS"):
        return os.environ["COORDINATOR_ADDRESS"]
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """``init_process_group`` with env-var fallbacks; returns True when a
    multi-process group was started (False: single-process, nothing to
    do).

    The world size comes from ``num_processes``, else
    ``IMG_ENV_NUM_PROCESSES`` or ``WORLD_SIZE``; the rank from
    ``process_id``, else ``RANK``; the address from
    ``coordinator_address`` (host:port), else ``COORDINATOR_ADDRESS`` or
    ``MASTER_ADDR``:``MASTER_PORT``.  ``backend``: 'nccl' where every rank
    has a card of its own (the default when this host has a card for each
    local rank), else 'gloo' (CPU tensors, or several ranks sharing one
    card: NCCL refuses two ranks on one device).  With NCCL the rank takes
    card ``LOCAL_RANK`` (default: rank modulo the host's cards).
    ``timeout_s`` bounds every collective, so a rank that dies ends its
    peers' waits with an error."""
    env = os.environ
    num = num_processes if num_processes is not None else int(
        env.get("IMG_ENV_NUM_PROCESSES", env.get("WORLD_SIZE", "1")))
    address = coordinator_address or _env_address()
    if num <= 1 and address is None:
        return False
    if address is None:
        raise ValueError(f"{num} processes need a coordinator address")
    rank = process_id if process_id is not None else int(env.get("RANK",
                                                                 "0"))
    local_size = int(env.get("LOCAL_WORLD_SIZE", num))
    if backend is None:
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() >= local_size else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(env.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(
        backend, init_method=f"tcp://{address}", world_size=num, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def global_mesh(scene: Optional[int] = None, model: int = 1,
                device_type: str = "cuda"):
    """Mesh over every rank of the job.  Scene blocks are laid out rank by
    rank, so each process's scenes are its own: batch construction needs
    only process-local data (``process_local_batch``)."""
    return make_mesh(scene=scene, model=model, device_type=device_type)


def process_local_batch(mesh, global_shape: Sequence[int],
                        local: torch.Tensor) -> DTensor:
    """A scene-sharded ``DTensor`` of ``global_shape`` from this rank's
    block ``local``; raises unless the blocks of the scene axis make up
    the global shape."""
    global_shape = tuple(int(d) for d in global_shape)
    want = (global_shape[0] // mesh.size(0),) + global_shape[1:]
    if global_shape[0] % mesh.size(0) or tuple(local.shape) != want:
        raise ValueError(f"a local block {tuple(local.shape)} is not this "
                         f"rank's part of {global_shape} over "
                         f"{mesh.size(0)} scene ranks")
    stride = torch.empty(global_shape, device="meta").stride()
    return DTensor.from_local(local.contiguous(), *scene_sharding(mesh),
                              run_check=False, shape=global_shape,
                              stride=stride)


# ---------------------------------------------------------------------------
# Ranks on this host
# ---------------------------------------------------------------------------

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULT = "RESULT "


class RankRun(NamedTuple):
    """What one spawned rank did: its exit code, its output and errors, and
    what its function returned (None unless it returned)."""

    rc: int
    out: str
    err: str
    result: object


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(target: str, nprocs: int, args: Sequence = (),
          backend: Optional[str] = None, timeout_s: float = 900.0,
          pg_timeout_s: float = DEFAULT_TIMEOUT_S,
          env: Optional[dict] = None) -> List[RankRun]:
    """Runs ``target`` ("package.module:function") with ``args`` (JSON
    values) in ``nprocs`` new processes, ranks 0..nprocs-1 of one process
    group at localhost (``initialize`` with ``backend`` and
    ``pg_timeout_s``).  Waits at most ``timeout_s`` for all of them, then
    kills what is left (its rc is then not 0).  ``env``: variables added
    to this process's.  Returns each rank's ``RankRun``."""
    address = f"localhost:{free_port()}"
    penv = dict(os.environ, **(env or {}))
    penv["PYTHONPATH"] = os.pathsep.join(
        [_REPO] + [p for p in [penv.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-m", "img_env_tpu_torch.parallel.distributed",
           target, str(nprocs), address, backend or "",
           str(pg_timeout_s), json.dumps(list(args))]
    files, procs = [], []
    try:
        for rank in range(nprocs):
            out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            files.append((out, err))
            procs.append(subprocess.Popen(
                cmd + [str(rank)], stdout=out, stderr=err, env=penv,
                cwd=_REPO))
        end = time.monotonic() + timeout_s
        for p in procs:
            try:
                p.wait(timeout=max(end - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    runs = []
    for p, (out, err) in zip(procs, files):
        texts = []
        for f in (out, err):
            f.seek(0)
            texts.append(f.read().decode(errors="replace"))
            f.close()
        lines = [x for x in texts[0].splitlines() if x.startswith(RESULT)]
        result = json.loads(lines[-1][len(RESULT):]) if lines else None
        runs.append(RankRun(p.returncode, texts[0], texts[1], result))
    return runs


def _rank_main(argv: Sequence[str]) -> None:
    """A spawned rank: joins the process group, runs its target, prints
    what it returned as a ``RESULT`` JSON line."""
    target, nprocs, address, backend, pg_timeout, args, rank = argv
    initialize(address, int(nprocs), int(rank), backend or None,
               float(pg_timeout))
    module, fn = target.split(":")
    try:
        out = getattr(importlib.import_module(module), fn)(*json.loads(args))
        print(RESULT + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
