"""Device mesh and sharding placements (torch port of
``img_env_tpu.parallel.mesh``).

The reference's only parallelism is one ROS node process per scene
(create_launch.py:25-34).  Here a scene is a batch index: scenes shard over
the ``scene`` (data-parallel) axis of a [scene, model] grid of ranks, with
an optional ``model`` axis for tensor-parallel policy layers.  The grid is
torch's ``DeviceMesh`` (``mesh_dim_names=("scene", "model")``) and the
placements are ``torch.distributed.tensor``'s ``Shard`` / ``Replicate``.
Each rank is one process; ``parallel/distributed.py`` starts the ranks'
process group, ``make_mesh`` starts a world of one when none is running.

A rank holds a contiguous block of the scenes (``scene_block``), the
host-major layout of ``distributed.global_mesh``.
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from img_env_tpu_torch.core.state import map_tree
from img_env_tpu_torch.models.policy import ATTN_HEADS

SCENE_AXIS = "scene"
MODEL_AXIS = "model"
# the process group's collective timeout: a rank that dies ends its peers'
# collectives with an error instead of hanging them
DEFAULT_TIMEOUT_S = 600.0


def start_world_of_one(backend: Optional[str] = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """A process group of this process alone (an in-memory store), so that
    a mesh of one works in a plain ``python`` process.  The default
    backend takes both devices (gloo for CPU tensors, NCCL for CUDA ones
    where torch has it), so that one process can build meshes of
    either."""
    if backend is None:
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   and dist.is_nccl_available() else "gloo")
    dist.init_process_group(
        backend, store=dist.HashStore(), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(scene: Optional[int] = None, model: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A [scene, model] mesh over the ranks of the process group (the first
    ``scene * model`` of them, as the JAX package truncates its devices).
    ``scene=None`` puts every remaining rank on the scene axis.  Without a
    process group it starts a world of one (``start_world_of_one``)."""
    if not dist.is_initialized():
        start_world_of_one()
    world = dist.get_world_size()
    if scene is None:
        scene = world // model
    if scene < 1 or model < 1 or scene * model > world:
        raise ValueError(f"a {scene} x {model} mesh needs {scene * model} "
                         f"ranks; the world has {world}")
    ranks = torch.arange(scene * model).reshape(scene, model)
    return DeviceMesh(device_type, ranks,
                      mesh_dim_names=(SCENE_AXIS, MODEL_AXIS))


def scene_spec() -> Tuple:
    """Placements over (scene, model): the leading (scene) dim sharded
    over the scene axis, replicated over the model axis."""
    return (Shard(0), Replicate())


def scene_sharding(mesh: DeviceMesh):
    """(mesh, placements) of a scene-batched tensor, as
    ``DTensor.from_local(x, *scene_sharding(mesh))`` takes them."""
    return mesh, scene_spec()


def replicated(mesh: DeviceMesh):
    """(mesh, placements) of a tensor every rank holds whole."""
    return mesh, (Replicate(), Replicate())


def scene_block(mesh: DeviceMesh, scenes: int) -> slice:
    """This rank's contiguous block of ``scenes`` global scenes: rank r of
    the scene axis holds [r*S/W, (r+1)*S/W).  Raises unless the scene axis
    divides S, as a JAX sharding of an indivisible dim does."""
    w = mesh.size(0)
    if scenes % w:
        raise ValueError(f"{scenes} scenes do not divide over the scene "
                         f"axis of {w} ranks")
    k = scenes // w
    r = mesh.get_local_rank(SCENE_AXIS)
    return slice(r * k, (r + 1) * k)


def shard_scenes(mesh: DeviceMesh, tree):
    """This rank's block of every tensor leaf (ndim >= 1) of a global
    scene-batched NamedTuple tree, or of one tensor."""
    take = lambda x: (x[scene_block(mesh, x.shape[0])]
                      if isinstance(x, torch.Tensor) and x.dim() >= 1
                      else x)
    return map_tree(take, tree)


# ---------------------------------------------------------------------------
# The Megatron plan of the policy's parameters over the model axis
# ---------------------------------------------------------------------------

_ROW_NAMES = ("fuse1", "vec1", "mlp")
_QKV = ("query", "key", "value")


def _flax_leaf(name: str, shape: Tuple[int, ...]):
    """The flax leaf a port parameter came from
    (``models/policy.policy_params_from_numpy``): its path's module names,
    its shape, and for each of its dims the dim of the port parameter's
    ``tp_view`` that holds it."""
    heads = ATTN_HEADS
    parts = name.split(".")
    leaf, mods = parts[-1], parts[:-1]
    if leaf == "pi_log_std":
        return ["pi_log_std"], shape, (0,)
    if mods and mods[-1] in _QKV + ("out",) and mods[0] == "crowd_attn":
        mods = mods[:-1] + ["attn", mods[-1]]
        if mods[-1] == "out":
            if leaf == "weight":               # [h*d, out] -> [h, d, out]
                o, hd = shape
                return mods + ["kernel"], (heads, hd // heads, o), (1, 1, 0)
            return mods + ["bias"], shape, (0,)
        if leaf == "weight":                   # [in, h, d]; view [h, d, in]
            hd, i = shape
            return mods + ["kernel"], (i, heads, hd // heads), (2, 0, 1)
        return mods + ["bias"], (heads, shape[0] // heads), (0, 1)
    if mods and mods[-2:-1] == ["convs"]:       # HWIO <- OIHW
        mods = mods[:-2] + [f"conv{mods[-1]}"]
        if leaf == "weight":
            o, i, kh, kw = shape
            return mods + ["kernel"], (kh, kw, i, o), (2, 3, 1, 0)
        return mods + ["bias"], shape, (0,)
    if leaf == "weight":                       # Dense [in, out] <- [out, in]
        return mods + ["kernel"], (shape[1], shape[0]), (1, 0)
    return mods + ["bias"], shape, (0,)


def _flax_sharded_dim(names, shape, size: int) -> Optional[int]:
    """The dim of a flax leaf that ``img_env_tpu.parallel.mesh.
    tp_param_shardings`` shards over a model axis of ``size`` (None:
    replicated)."""
    if size <= 1:
        return None
    in_row = any(n in _ROW_NAMES for n in names)
    is_kernel = names[-1] == "kernel"
    nd = len(shape)
    if is_kernel and in_row and nd == 2 and shape[0] % size == 0:
        return 0
    if nd >= 2 and not in_row and shape[-1] % size == 0:
        return nd - 1
    if (names[-1] == "bias" and not in_row and nd == 1
            and shape[0] % size == 0):
        return 0
    return None


def tp_view(name: str, x: torch.Tensor):
    """The view of a parameter that its placement addresses: the
    attention's query / key / value weights [h*d, in] as [h, d, in] and
    their biases [h*d] as [h, d] (flax's head-split layout, whose d the
    plan shards); every other parameter as it is."""
    parts = name.split(".")
    if parts[0] == "crowd_attn" and parts[-2] in _QKV:
        return x.unflatten(0, (ATTN_HEADS, -1))
    return x


def tp_param_shardings(params: Dict[str, torch.Tensor],
                       mesh: DeviceMesh) -> Dict[str, Tuple]:
    """Megatron-style tensor-parallel placements over (scene, model) for
    each of the policy's parameters (a state dict), the JAX package's plan
    (img_env_tpu/parallel/mesh.py:67-104) through the layout mapping:

      * column (output-dim) sharded: conv kernels, trunk projections, the
        first layer of each MLP pair (fuse0 / vec0 / embed), the
        attention's projections, and their biases: ``Shard(0)`` on a
        weight [out, in] or [out, in, kh, kw] (flax's [in, out] and HWIO
        shard their last dim), ``Shard(1)`` on the [h, d, in] view of a
        query / key / value weight;
      * row (input-dim) sharded: the second layer of each pair (fuse1 /
        vec1 / mlp): ``Shard(1)`` on the weight; its bias replicates;
      * everything else replicates, and so does a dim the model axis does
        not divide.

    Placements address ``tp_view(name, param)``; the scene axis always
    replicates parameters."""
    size = mesh.size(1)
    plan = {}
    for name, x in params.items():
        names, shape, to_port = _flax_leaf(name, tuple(x.shape))
        d = _flax_sharded_dim(names, shape, size)
        plan[name] = (Replicate(),
                      Replicate() if d is None else Shard(to_port[d]))
    return plan


def tp_sharded_fraction(params: Dict[str, torch.Tensor], plan) -> float:
    """Fraction of parameter bytes sharded over the model axis."""
    total = sharded = 0
    for name, x in params.items():
        n = x.numel() * x.element_size()
        total += n
        if any(isinstance(p, Shard) for p in plan[name]):
            sharded += n
    return sharded / max(total, 1)


def host_mesh(n: int) -> DeviceMesh:
    """CPU mesh of ``n`` gloo ranks for tests: each of the n processes calls
    it after joining the process group."""
    return make_mesh(scene=n, model=1, device_type="cpu")
