"""The kernels' CUDA sources ship with the port's package: an installed
wheel builds them at first use, so every file under
``img_env_tpu_torch/csrc/`` must match a package-data glob."""

import fnmatch
import os
import tomllib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "img_env_tpu_torch")


def test_csrc_is_package_data():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)
    globs = data["tool"]["setuptools"]["package-data"]["img_env_tpu_torch"]
    files = sorted(os.listdir(os.path.join(PKG, "csrc")))
    assert files
    for name in files:
        rel = f"csrc/{name}"
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel


def test_kernel_sources_are_the_csrc_files():
    """ops/kernels.py builds exactly the sources that ship."""
    from img_env_tpu_torch.ops import kernels

    cu = sorted(n for n in os.listdir(os.path.join(PKG, "csrc"))
                if n.endswith(".cu"))
    assert sorted(kernels.SOURCES) == cu
    assert set(kernels.LAUNCHES) == set(kernels._SIGNATURES)


def test_maps_are_package_data_and_equal_the_originals():
    """The port ships its own copy of the map PNGs: each matches a
    package-data glob and is byte-equal to the JAX package's file."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)
    globs = data["tool"]["setuptools"]["package-data"]["img_env_tpu_torch"]
    ours = sorted(os.listdir(os.path.join(PKG, "maps")))
    theirs = sorted(n for n in os.listdir(os.path.join(REPO, "img_env_tpu",
                                                       "maps"))
                    if n.endswith(".png"))
    assert ours == theirs
    for name in ours:
        assert any(fnmatch.fnmatch(f"maps/{name}", g) for g in globs), name
        with open(os.path.join(PKG, "maps", name), "rb") as a, \
                open(os.path.join(REPO, "img_env_tpu", "maps", name),
                     "rb") as b:
            assert a.read() == b.read(), name


def test_config_resolves_maps_inside_the_port():
    from img_env_tpu_torch.config import EnvConfig

    from tests.test_torch_env import small_cfg_dict

    cfg = EnvConfig.from_dict(small_cfg_dict())
    path = os.path.realpath(cfg.resolve_map_path())
    assert path == os.path.realpath(os.path.join(PKG, "maps",
                                                 cfg.map_file))


def test_navenv_defaults_to_the_card():
    """NavEnv(cfg) runs on the card; without one it raises and never
    builds on the CPU."""
    import pytest
    import torch

    from img_env_tpu_torch import EnvConfig, NavEnv

    from tests.test_torch_env import small_cfg_dict

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NavEnv(EnvConfig.from_dict(small_cfg_dict()))


def test_policy_artifacts_are_package_data():
    """The committed policies (the stage-5 and the ERVO npz, each with its
    env json) ship with the package, and git does not ignore them."""
    import subprocess

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)
    globs = data["tool"]["setuptools"]["package-data"]["img_env_tpu_torch"]
    names = sorted(os.listdir(os.path.join(PKG, "artifacts")))
    assert names == ["ervo_policy.npz", "ervo_policy_env.json",
                     "stage5_policy.npz", "stage5_policy_env.json"]
    for name in names:
        rel = f"artifacts/{name}"
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel
        ignored = subprocess.run(
            ["git", "check-ignore", "-q", os.path.join(PKG, rel)], cwd=REPO)
        assert ignored.returncode == 1, rel
