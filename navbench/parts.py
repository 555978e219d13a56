"""Finding a cell's parts by name: the files under the checkout's
``navbench/`` that belong to one loop, actor or metric.  Standard library
only, so that the entry can report a missing part before it loads torch."""

from __future__ import annotations

import importlib.util
import os


class RunError(Exception):
    """A run that cannot report: no card, a missing file, a forbidden
    import."""


def load_part(here: str, kind: str, name: str):
    """``<here>/<kind>/<name>.py`` as a module (``here``: the checkout's
    ``navbench`` directory; ``kind``: 'loops', 'actors' or 'metrics')."""
    path = os.path.join(here, kind, name + ".py")
    if not os.path.exists(path):
        raise RunError(f"no navbench/{kind}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"navbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
