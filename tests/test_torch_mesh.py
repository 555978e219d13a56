"""The port's device mesh (``img_env_tpu_torch.parallel.mesh``) against the
JAX package's (``img_env_tpu.parallel.mesh``).

The tensor-parallel plan of tests/test_parallel.py's tiny config is made
by the port on a 2 x 2 [scene, model] mesh of four gloo ranks on the CPU
(``tests/torch_ranks.py:tp_plan``) and by the JAX package on a 2 x 2 mesh
of the CPU devices that tests/conftest.py forces; each JAX leaf's
PartitionSpec is carried through the layout mapping written out below
(flax Dense [in, out] -> torch [out, in]; conv HWIO -> OIHW; the
attention's query / key / value kernels [in, heads, d] -> the [heads, d,
in] view of the torch weight, their biases [heads, d] as they are, its
output kernel [heads, d, out] -> [out, heads * d]) and must equal the
port's placement, leaf for leaf.
"""

import flax
import jax
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.models import policy as jpolicy
from img_env_tpu.parallel import mesh as jmesh
from img_env_tpu_torch.parallel import mesh
from img_env_tpu_torch.parallel.distributed import spawn
from img_env_tpu_torch.parallel.dryrun import tiny_cfg_dict

TINY = tiny_cfg_dict(robots=1, peds=1)


def _expected(path, spec, ndim):
    """The port's parameter name and model-axis placement of a flax leaf
    at ``path`` with ``spec``."""
    mods, leaf = list(path[1:-1]), path[-1]
    dims = [i for i, a in enumerate(tuple(spec) + (None,) * ndim)
            if a == jmesh.MODEL_AXIS]
    if "attn" in mods:
        mods.remove("attn")
        if mods[-1] == "out":
            to_port = {2: 0} if leaf == "kernel" else {0: 0}
        else:                                   # query / key / value
            to_port = {0: 2, 1: 0, 2: 1} if leaf == "kernel" else {0: 0,
                                                                   1: 1}
    elif leaf == "kernel" and ndim == 4:        # conv HWIO -> OIHW
        mods = mods[:-1] + ["convs", mods[-1][len("conv"):]]
        to_port = {0: 2, 1: 3, 2: 1, 3: 0}
    elif leaf == "kernel":
        to_port = {0: 1, 1: 0}
    else:
        if mods and mods[-1].startswith("conv"):
            mods = mods[:-1] + ["convs", mods[-1][len("conv"):]]
        to_port = {0: 0, 1: 1}
    name = ".".join(mods + ["weight" if leaf == "kernel" else leaf])
    place = Shard(to_port[dims[0]]) if dims else Replicate()
    return name, place


@pytest.fixture(scope="module")
def plans():
    """(the JAX plan's expected port placements by name, its sharded
    fraction, what every port rank returned)."""
    jcfg = JaxEnvConfig.from_dict(TINY)
    jm = jmesh.make_mesh(scene=2, model=2, devices=jax.devices()[:4])
    _, params = jpolicy.init_policy(
        jax.random.PRNGKey(0), jpolicy.PolicyConfig.from_env_config(jcfg),
        batch=4)
    sh = jmesh.tp_param_shardings(params, jm)
    flat_p = flax.traverse_util.flatten_dict(params)
    flat_s = flax.traverse_util.flatten_dict(sh)
    want = dict(_expected(k, flat_s[k].spec, flat_p[k].ndim)
                for k in flat_p)
    runs = spawn("tests.torch_ranks:tp_plan", 4, [TINY, 0], backend="gloo",
                 timeout_s=150, pg_timeout_s=60,
                 env={"OMP_NUM_THREADS": "1"})
    for rank, r in enumerate(runs):
        assert r.rc == 0, (rank, r.out[-2000:], r.err[-4000:])
    return want, jmesh.tp_sharded_fraction(params, sh), [r.result
                                                          for r in runs]


def test_tp_plan_matches_jax_leaf_for_leaf(plans):
    want, _, res = plans
    for r in res:
        got = r["plan"]
        assert sorted(got) == sorted(want)
        for name, place in want.items():
            assert got[name] == [repr(Replicate()), repr(place)], name


def test_tp_sharded_fraction_matches_jax(plans):
    _, frac, res = plans
    assert frac > 0.5
    for r in res:
        assert r["fraction"] == frac


def test_plan_has_column_and_row_shards(plans):
    """Megatron pairs (tests/test_parallel.py:126-132): column-sharded
    weights (Shard(0): flax's P(None, 'model')) and row-sharded ones
    (Shard(1): P('model', None)) both appear."""
    want, _, _ = plans
    assert want["fuse0.weight"] == Shard(0)
    assert want["fuse1.weight"] == Shard(1)
    assert want["fuse1.bias"] == Replicate()


def test_shard_scenes_and_divisibility(plans):
    """Rank r of the scene axis holds scenes [2r, 2r + 2) of 4 (the two
    model ranks of a scene row alike); 3 scenes do not divide."""
    _, _, res = plans
    assert [r["shard"] for r in res] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert all(r["indivisible_raises"] for r in res)


def test_make_mesh_starts_a_world_of_one():
    started = not dist.is_initialized()
    try:
        m = mesh.make_mesh(device_type="cpu")
        assert dist.get_world_size() == 1
        assert m.mesh_dim_names == (mesh.SCENE_AXIS, mesh.MODEL_AXIS)
        assert (m.size(0), m.size(1)) == (1, 1)
        x = torch.arange(6).reshape(3, 2)
        assert torch.equal(mesh.shard_scenes(m, x), x)
        assert mesh.scene_spec() == (Shard(0), Replicate())
        with pytest.raises(ValueError):
            mesh.make_mesh(scene=2, device_type="cpu")
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
