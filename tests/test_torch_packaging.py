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
