"""The port's library leftovers against the JAX package's: SE(2) frames
(``core/frames.py``), the statics cache (``utils/statics_cache.py``) and
the NaN trap (``utils/debug.py``).

Frames: 200 seeded float32 poses, points and angles through each JAX
function jitted (x64 off) and its port, bit for bit (glibc's sin/cos and
XLA's fused multiply-adds, F21's forms), except ``wrap_angle``: torch's
float32 atan2 and XLA's differ by up to one ulp at pi, so it is held
within 2.4e-7.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

import tests.test_torch_env  # noqa: F401  (one torch thread per worker)
from img_env_tpu.core import frames as jframes
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.core import frames
from img_env_tpu_torch.env import nav_env
from img_env_tpu_torch.env.nav_env import NavEnv
from img_env_tpu_torch.utils import statics_cache
from img_env_tpu_torch.utils.debug import nan_debug
from tests.test_torch_env import ped_cfg_dict, small_cfg_dict

N, P = 200, 5


def _inputs():
    rng = np.random.default_rng(0)
    pose = np.stack([rng.uniform(-10, 10, N), rng.uniform(-10, 10, N),
                     rng.uniform(-20, 20, N)], -1).astype(np.float32)
    return dict(pose=pose,
                pts=rng.uniform(-5, 5, (N, P, 2)).astype(np.float32),
                goal=rng.uniform(-10, 10, (N, 2)).astype(np.float32),
                ang=rng.uniform(-50, 50, (N,)).astype(np.float32))


CASES = {
    "rot2d": (("ang",), {}),
    "apply_rot": (("ang", "pts"), {}),
    "apply_se2": (("pose", "pts"), {}),
    "inv_se2": (("pose",), {}),
    "world_to_base": (("pose", "pts"), {}),
    "goal_in_base": (("pose", "goal"), {}),
    "base_to_view": (("pts",), {"half_extent": 1.5}),
    "view_to_base": (("pts",), {"half_extent": 1.5}),
    "wrap_angle": (("ang",), {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_frames_match_jax(name):
    args, kw = CASES[name]
    x = _inputs()
    with jax.enable_x64(False):
        fn = getattr(jframes, name)
        want = jax.jit(lambda *a: fn(*a, **kw))(*(x[a] for a in args))
    got = getattr(frames, name)(*(torch.as_tensor(x[a]) for a in args),
                                **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        if name == "wrap_angle":
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2.4e-7)
        else:
            np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# the statics cache
# ---------------------------------------------------------------------------


def _same(a, b, path="statics"):
    """Equal trees of NamedTuples, tuples, numpy arrays and scalars."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), path
        names = getattr(a, "_fields", range(len(a)))
        for n, x, y in zip(names, a, b):
            _same(x, y, f"{path}.{n}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif hasattr(a, "__dict__"):
        _same(tuple(vars(a).values()), tuple(vars(b).values()), path)
    else:
        assert a == b, path


def _files(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def test_statics_cache_round_trip(tmp_path, monkeypatch):
    """A cold NavEnv writes its statics and painter tables; a warm one
    loads them (the builds are not called) and equals the cold one."""
    monkeypatch.setenv(statics_cache.ENV_VAR, str(tmp_path))
    cfg = EnvConfig.from_dict(small_cfg_dict())
    cold = NavEnv(cfg, "cpu")
    assert cold.group_tables[0].painter is not None
    names = _files(tmp_path)
    assert [n.split("-")[1] for n in names] == ["kst", "st"]

    def refuse(*a, **k):
        raise AssertionError("built where the cache holds it")

    monkeypatch.setattr(nav_env, "build_statics", refuse)
    monkeypatch.setattr(nav_env.painter_mod.PaintSlots, "build", refuse)
    warm = NavEnv(cfg, "cpu")
    _same(warm.statics, cold.statics)
    _same(warm.group_tables, cold.group_tables, "group_tables")
    assert _files(tmp_path) == names


def test_statics_cache_key_follows_sources_and_config(tmp_path):
    src = tmp_path / "pkg"
    (src / "csrc").mkdir(parents=True)
    (src / "a.py").write_text("x = 1\n")
    (src / "csrc" / "k.cu").write_text("// kernel\n")
    (src / "notes.txt").write_text("not a source\n")
    cfg = EnvConfig.from_dict(small_cfg_dict())
    key = lambda c=cfg: statics_cache.cache_key(
        c, c.resolve_map_path(), statics_cache.package_fingerprint(str(src)))
    k0 = key()
    assert key() == k0
    (src / "notes.txt").write_text("still not a source, longer\n")
    assert key() == k0
    (src / "a.py").write_text("x = 22\n")
    k1 = key()
    assert k1 != k0
    (src / "csrc" / "k.cu").write_text("// kernel, edited\n")
    k2 = key()
    assert k2 not in (k0, k1)
    assert key(EnvConfig.from_dict(small_cfg_dict(n_obs=2))) != k2
    assert statics_cache.cache_key(cfg, cfg.resolve_map_path()) != k2


def test_statics_cache_corrupt_entry_rebuilds(tmp_path, monkeypatch):
    monkeypatch.setenv(statics_cache.ENV_VAR, str(tmp_path))
    cfg = EnvConfig.from_dict(small_cfg_dict())
    cold = NavEnv(cfg, "cpu")
    for name in _files(tmp_path):
        (tmp_path / name).write_bytes(b"not a pickle")
    again = NavEnv(cfg, "cpu")
    _same(again.statics, cold.statics)
    _same(again.group_tables, cold.group_tables, "group_tables")
    # the rebuilt entries replaced the corrupt ones
    st = [n for n in _files(tmp_path) if n.startswith("statics-st-")][0]
    with open(tmp_path / st, "rb") as f:
        _same(pickle.load(f), cold.statics)


def test_statics_cache_off_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv(statics_cache.ENV_VAR, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert statics_cache.cache_dir() is None
    NavEnv(EnvConfig.from_dict(small_cfg_dict()), "cpu")
    assert _files(tmp_path) == []


# ---------------------------------------------------------------------------
# the NaN trap
# ---------------------------------------------------------------------------


def test_nan_debug_raises_on_nan_and_overflow():
    with pytest.raises(FloatingPointError, match="aten.log"):
        with nan_debug():
            torch.log(torch.tensor([-1.0, 2.0]))
    with pytest.raises(FloatingPointError, match="aten.exp"):
        with nan_debug():
            torch.exp(torch.tensor([100.0]))
    with nan_debug(enable=False):
        torch.log(torch.tensor([-1.0]))


@pytest.mark.parametrize("cfg_fn", [small_cfg_dict, ped_cfg_dict],
                         ids=["obstacles", "sfm_peds"])
def test_nan_debug_is_silent_on_a_clean_step(cfg_fn):
    env = NavEnv(EnvConfig.from_dict(cfg_fn()), "cpu")
    state, _ = env.reset()
    actions = torch.tensor([[0.3, 0.2, 0.0]]).repeat(env.cfg.robot.total, 1)
    with nan_debug():
        state, obs, *_ = env.step(state, actions)
    assert bool(torch.isfinite(obs.sensor_maps).all())
