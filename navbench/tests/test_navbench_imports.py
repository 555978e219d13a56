"""No module under navbench imports jax, jaxlib, flax or the JAX package
``img_env_tpu``, compared by whole top-level name (``img_env_tpu_torch``
is the program, not the JAX package); the frozen reference imports nothing
of the program, nor do the comparison and the yardstick."""

import ast
import os

import pytest

import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "img_env_tpu"}


def _modules():
    for dirpath, dirnames, files in os.walk(tiny.HERE):
        dirnames[:] = [d for d in dirnames if not d.startswith(".")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, tiny.HERE))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    users = {os.path.relpath(p, tiny.HERE) for p in _modules()
             if "img_env_tpu_torch" in set(_imports(p))}
    assert "run.py" in users
    assert not any(p.startswith(("reference", "check", "yardstick"))
                   for p in users)


def test_whole_name_comparison():
    assert "img_env_tpu_torch".split(".")[0] not in FORBIDDEN
