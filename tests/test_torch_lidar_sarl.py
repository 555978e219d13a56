"""The port's laser encodings (``img_env_tpu_torch.utils.lidar``), its
SARL rows (``utils.sarl``) and ``ops.f32.exp``/``log`` against the JAX
package's jitted float32 functions, bit for bit.

XLA's CPU build computes float32 ``exp`` and ``log`` with its own
polynomials, not torch's (nearly correctly rounded) ones: over a range of
values torch's differ from XLA's on about a tenth of them, and 36 of the
log-polar map's 48 left bin edges at max range 6.0 would differ.  The
port spells XLA's arithmetic out (``ops.f32``), so the edges, and every
map cell, are bit-equal; the tests below show a range at an edge that
torch's own edges would put in the other cell.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img_env_tpu.utils import lidar as jlidar
from img_env_tpu.utils import sarl as jsarl
from img_env_tpu_torch.ops import f32
from img_env_tpu_torch.utils import lidar, sarl
import tests.test_torch_env  # noqa: F401  (one torch thread per worker)


@functools.lru_cache(maxsize=None)
def _jit(name, *static):
    """A jitted float32 JAX lidar function, built once per (name, args)."""
    fn = getattr(jlidar, name)
    return jax.jit(lambda x: fn(x, *static))


def _jax(name, x, *static):
    with jax.enable_x64(False):
        return np.asarray(_jit(name, *static)(jnp.asarray(x, jnp.float32)))


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return bool(np.all((a.view(np.int32) == b.view(np.int32))
                       | (np.isnan(a) & np.isnan(b))))


@pytest.mark.parametrize("name", ["exp", "log"])
def test_exp_log_bits_match_xla(name):
    """``f32.exp``/``f32.log`` equal XLA's jitted float32 functions on
    every value drawn, specials and subnormals included; torch's own
    functions do not."""
    rng = np.random.default_rng(0)
    if name == "exp":
        xs = np.concatenate([rng.uniform(-90.0, 90.0, 40000),
                             rng.uniform(0.0, 2.0, 40000),
                             [0.0, -0.0, 1e-40, -1e-40, 88.7, -87.5,
                              np.inf, -np.inf, np.nan]])
        jf = jnp.exp
    else:
        xs = np.concatenate([rng.uniform(0.0, 20.0, 40000),
                             np.exp(rng.uniform(-87.0, 88.0, 40000)),
                             [0.0, -0.0, 1e-40, -1e-40, -1.0, 7.0,
                              np.inf, -np.inf, np.nan]])
        jf = jnp.log
    xs = xs.astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(jf)(xs))
    got = getattr(f32, name)(torch.from_numpy(xs)).numpy()
    assert _bits_equal(got, want)
    assert not _bits_equal(getattr(torch, name)(torch.from_numpy(xs)), want)


def test_log_map_edges_at_max_range_6():
    """The 49 bin edges of the log-polar strip at max range 6.0 (48 left
    edges and the last right edge, 6.0) are XLA's: a range on each edge
    and one ulp below it lands in JAX's cell; torch's own exp/log move
    36 of the left edges, so ranges on them would flip cells."""
    e_left, e_right = lidar.log_map_edges(torch.tensor(6.0), 48)
    edges = np.concatenate([e_left.numpy(), e_right.numpy()[-1:]])
    assert edges.shape == (49,) and edges[-1] == np.float32(6.0)
    probe = np.concatenate([edges, np.nextafter(edges, np.float32(0)),
                            np.nextafter(edges, np.float32(7))])
    probe = probe.astype(np.float32)
    want = _jax("lidar_log_map", probe, 48)
    got = lidar.lidar_log_map(torch.from_numpy(probe), 48).numpy()
    np.testing.assert_array_equal(got, want)
    gap = torch.log(torch.tensor(7.0)) / 48
    naive = torch.exp(torch.arange(48) * gap) - 1.0
    moved = (naive != e_left).numpy()
    assert moved.sum() == 36
    # a range on a moved edge (each lies below XLA's): torch's own edges
    # would call cell i the hit cell, XLA's and the port's cell i - 1
    i = int(np.nonzero(moved)[0][0])
    assert bool(naive[i] < e_left[i])
    r = naive[i:i + 1].numpy()
    row = _jax("lidar_log_map", r, 48)[0]
    np.testing.assert_array_equal(
        lidar.lidar_log_map(torch.from_numpy(r), 48).numpy()[0], row)
    assert row[i - 1] == 1.0 and row[i] == 0.5


@pytest.mark.parametrize("length", [48, 16, 37])
@pytest.mark.parametrize("over", [False, True], ids=["max6", "max9.5"])
def test_strip_maps_match_jax(length, over):
    """``lidar_to_map``, ``lidar_log_map`` (whose edges follow the
    largest range) and ``lidar_e_map`` on random [5, 40] scans."""
    rng = np.random.default_rng(length)
    x = rng.uniform(0.0, 6.2, (5, 40)).astype(np.float32)
    if over:
        x[2, 7] = 9.5
    for name in ("lidar_to_map", "lidar_log_map", "lidar_e_map"):
        got = getattr(lidar, name)(torch.from_numpy(x), length).numpy()
        want = _jax(name, x, length)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_sampling_and_polar_match_jax():
    rng = np.random.default_rng(1)
    scan = rng.uniform(0.2, 8.0, (3, 960)).astype(np.float32)
    for args in ((20,), (20, True), (7,)):
        np.testing.assert_array_equal(
            lidar.down_sample(torch.from_numpy(scan), *args).numpy(),
            _jax("down_sample", scan, *args))
    np.testing.assert_array_equal(
        lidar.normal_sample(torch.from_numpy(scan), 3).numpy(),
        _jax("normal_sample", scan, 3))
    strip = rng.uniform(0.0, 1.0, (2, 24, 48)).astype(np.float32)
    for log_radius in (False, True):
        np.testing.assert_array_equal(
            lidar.polar_to_cartesian(torch.from_numpy(strip), 48,
                                     log_radius).numpy(),
            _jax("polar_to_cartesian", strip, 48, log_radius))


def test_trans_lidar_log_map_matches_jax_on_random_scans():
    """The frontend's whole sensor-map pipeline on 40 random 960-beam
    scans (ranges past max range, inf and exact edge values included)."""
    rng = np.random.default_rng(2)
    scans = rng.uniform(0.05, 7.0, (40, 960)).astype(np.float32)
    e_left, _ = lidar.log_map_edges(torch.tensor(6.0), 48)
    scans[0, ::20] = e_left.numpy()
    scans[1, :100] = np.inf
    for s in scans:
        want = _jax("trans_lidar_log_map", s)
        got = lidar.trans_lidar_log_map(torch.from_numpy(s)).numpy()
        assert got.shape == (48, 48)
        np.testing.assert_array_equal(got, want)


@functools.lru_cache(maxsize=None)
def _jax_sarl(ped_vec_dim, max_ped):
    return jax.jit(lambda v, p: jsarl.batched_sarl_states(
        v, p, 0.17, ped_vec_dim, max_ped))


@pytest.mark.parametrize("ped_vec_dim,max_ped", [(7, 10), (5, 4)])
def test_sarl_rows_and_masks_match_jax(ped_vec_dim, max_ped):
    """Rows and masks over 300 robots, a fifth of them seeing no ped (the
    dummy ped row) and one count past ``max_ped``."""
    rng = np.random.default_rng(ped_vec_dim)
    n = 300
    vec = (rng.normal(size=(n, 5)) * 3).astype(np.float32)
    ped = rng.normal(size=(n, 1 + ped_vec_dim * max_ped)).astype(np.float32)
    ped[:, 0] = rng.integers(0, max_ped + 1, n)
    ped[::5, 0] = 0
    ped[1, 0] = max_ped + 3
    with jax.enable_x64(False):
        rows_j, valid_j = _jax_sarl(ped_vec_dim, max_ped)(vec, ped)
    rows_t, valid_t = sarl.batched_sarl_states(
        torch.from_numpy(vec), torch.from_numpy(ped), 0.17, ped_vec_dim,
        max_ped)
    assert _bits_equal(rows_t.numpy(), rows_j)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    # one robot through the unbatched form, the JAX one eager
    r1, v1 = sarl.concat_sarl_states(torch.from_numpy(vec[5]),
                                     torch.from_numpy(ped[5]), 0.17,
                                     ped_vec_dim, max_ped)
    with jax.enable_x64(False):
        r2, v2 = jsarl.concat_sarl_states(jnp.asarray(vec[5]),
                                          jnp.asarray(ped[5]), 0.17,
                                          ped_vec_dim, max_ped)
    np.testing.assert_array_equal(r1.numpy(), np.asarray(r2))
    np.testing.assert_array_equal(v1.numpy(), np.asarray(v2))
    assert v1.tolist() == [True] + [False] * (max_ped - 1)   # dummy ped
    np.testing.assert_array_equal(
        r1[0, 7:].numpy(), np.float32([10, 10, 0.5, 0.5, 0.2, 0.37,
                                       14])[:ped_vec_dim])
