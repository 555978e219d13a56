"""Opt-in disk cache for host-built env statics (torch port of
``img_env_tpu.utils.statics_cache``).

Building ``EnvStatics`` and the painter's launch tables is host-side
Python (slot layout, beam walks, visit lists: seconds for the 400x400 /
960-beam production shape), and every process of a multi-rank run builds
them.  They are a pure function of (config, map file, package source), so
processes can share them:

    export IMG_ENV_TPU_STATICS_CACHE=~/.cache/img_env_tpu

The key hashes the config's repr, the map file's bytes, and a fingerprint
of every ``.py`` and ``.cu`` file of the port: any source or map edit
misses the entry, so a stale cache cannot reach a parity result.  Entries
are pickles written atomically (a temporary file, then a rename); an entry
that does not load is rebuilt.  With the variable unset nothing is read or
written.  (The reference has no analogue: every ROS node rebuilds its
tables at launch, img_env.cpp:169-193.)
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
from typing import Any, Callable, Optional

ENV_VAR = "IMG_ENV_TPU_STATICS_CACHE"
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = (".py", ".cu")


def cache_dir() -> Optional[str]:
    d = os.environ.get(ENV_VAR, "")
    return os.path.expanduser(d) if d else None


def package_fingerprint(root: str = PACKAGE_ROOT) -> str:
    """Hash of (relative path, size, mtime_ns) of every ``.py`` and ``.cu``
    file under ``root``."""
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for f in sorted(filenames):
            if not f.endswith(_SOURCES):
                continue
            p = os.path.join(dirpath, f)
            st = os.stat(p)
            h.update(os.path.relpath(p, root).encode())
            h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()


def cache_key(cfg, map_path: Optional[str],
              fingerprint: Optional[str] = None) -> str:
    """The entry key of ``cfg`` with the map at ``map_path`` under the
    package source's ``fingerprint`` (default: this package's now)."""
    h = hashlib.sha256()
    h.update(repr(cfg).encode())
    h.update((fingerprint or package_fingerprint()).encode())
    if map_path and os.path.exists(map_path):
        with open(map_path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:32]


def _path(key: str) -> Optional[str]:
    d = cache_dir()
    return os.path.join(d, f"statics-{key}.pkl") if d else None


def load(key: str) -> Optional[Any]:
    """The entry at ``key``, or None (no cache, no entry, or one that does
    not unpickle)."""
    path = _path(key)
    if path is None:
        return None
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except (OSError, EOFError, pickle.UnpicklingError, AttributeError,
            ImportError, IndexError, TypeError, ValueError):
        return None


def save(key: str, obj: Any) -> None:
    """Writes the entry atomically; a cache that cannot be written is
    skipped (the build stands)."""
    path = _path(key)
    if path is None:
        return
    tmp = None
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        tmp = None
    except OSError:
        pass
    finally:
        if tmp is not None and os.path.exists(tmp):
            os.remove(tmp)


def cached(key: Optional[str], build: Callable[[], Any],
           valid: Callable[[Any], bool]) -> Any:
    """The entry at ``key`` if it loads and passes ``valid``, else
    ``build()``, saved under ``key`` (``key`` None: no cache)."""
    if key is not None:
        obj = load(key)
        if obj is not None and valid(obj):
            return obj
    obj = build()
    if key is not None:
        save(key, obj)
    return obj
