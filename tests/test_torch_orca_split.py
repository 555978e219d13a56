"""RVO2's obstacle kd-tree segment split in the torch port
(crowd/obstacle_split.py) vs the JAX worklist and the sequential oracle
build (img_env_tpu/oracle/orca_oracle.split_segments_from_rects).

The boolean fields (convexity, validity) and the order of the segments
equal the JAX package's; the points agree within 1e-12 in float64 and are
equal in float32 (axis-aligned edges: every partition test is one rounded
product).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img_env_tpu.crowd.obstacle_split import split_segments as jsplit
from img_env_tpu.crowd.orca import OrcaConfig as JaxOrcaConfig
from img_env_tpu.crowd.orca import orca_step as jax_orca_step
from img_env_tpu.oracle import orca_oracle
from img_env_tpu_torch.crowd import orca
from img_env_tpu_torch.crowd.obstacle_split import split_segments

from tests.test_orca_split import _canon_oracle, _random_layout

T = torch.as_tensor


def _assert_segments_equal(got, want, atol):
    for f in orca.Segments._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=f)


def _canon_torch(s):
    v = s.valid.numpy()
    p1, p2 = s.p1.numpy(), s.p2.numpy()
    c1, c2 = s.convex1.numpy(), s.convex2.numpy()
    return sorted((round(p1[i, 0], 9), round(p1[i, 1], 9), round(p2[i, 0], 9),
                   round(p2[i, 1], 9), bool(c1[i]), bool(c2[i]))
                  for i in range(len(v)) if v[i])


@pytest.mark.parametrize("trial", range(8))
def test_split_matches_jax_and_oracle(trial):
    rng = np.random.default_rng(40 + trial)
    aabbs = _random_layout(rng, int(rng.integers(1, 7)))
    valid = np.ones(len(aabbs), bool)
    want, ovf_j = jax.jit(jsplit)(jnp.asarray(aabbs), jnp.asarray(valid))
    got, ovf = split_segments(T(aabbs), T(valid))
    assert not bool(ovf) and not bool(ovf_j)
    _assert_segments_equal(got, want, 1e-12)
    assert _canon_torch(got) == _canon_oracle(
        orca_oracle.split_segments_from_rects(aabbs))


def test_split_f32_equals_jax():
    """The production dtype: the jitted JAX split and the port's agree
    exactly on layouts with shared edges."""
    rng = np.random.default_rng(7)
    for _ in range(4):
        aabbs = _random_layout(rng, 5).astype(np.float32)
        with jax.enable_x64(False):
            want, _ = jax.jit(jsplit)(aabbs, np.ones(len(aabbs), bool))
        got, _ = split_segments(T(aabbs), torch.ones(len(aabbs),
                                                     dtype=torch.bool))
        assert got.p1.dtype == torch.float32
        _assert_segments_equal(got, want, 0.0)


def test_split_overflow_flag():
    """A layout that needs more splits than ``extra`` slots: the surplus
    straddlers stay whole, the flag is set, and the partial result equals
    the JAX package's under the same capacity rule."""
    aabbs = np.array([[2.0, 2.0, 3.0, 3.0], [3.0, 2.0, 4.0, 3.0],
                      [2.0, 5.0, 6.0, 5.5], [5.0, 1.0, 5.5, 6.0],
                      [1.0, 2.5, 7.0, 2.7]])
    valid = np.ones(len(aabbs), bool)
    for extra in (1, 3):
        want, ovf_j = jsplit(jnp.asarray(aabbs), jnp.asarray(valid),
                             extra=extra)
        got, ovf = split_segments(T(aabbs), T(valid), extra=extra)
        assert bool(ovf) and bool(ovf_j)
        assert int(got.valid.sum()) == 4 * len(aabbs) + extra
        _assert_segments_equal(got, want, 1e-12)
    got, ovf = split_segments(T(aabbs), T(valid))
    assert not bool(ovf)


def test_invalid_obstacles_excluded():
    aabbs = np.array([[2.0, 2.0, 3.0, 3.0], [3.0, 2.0, 4.0, 3.0]])
    valid = np.array([True, False])
    want, _ = jsplit(jnp.asarray(aabbs), jnp.asarray(valid))
    got, _ = split_segments(T(aabbs), T(valid))
    assert int(got.valid.sum()) == 4
    _assert_segments_equal(got, want, 1e-12)


def test_solve_on_adversarial_layout_matches_oracle():
    """tests/test_orca_split.py's layout where unsplit segments diverge by
    ~0.5 m/s: the port's split + solve against the faithful oracle and the
    JAX solver."""
    rng = np.random.default_rng(0)
    aabbs = np.array([[2.0, 5.0, 6.0, 5.5], [1.0, 5.3, 2.5, 6.3],
                      [2.5, 4.0, 3.5, 5.36]])
    m = 6
    pos = rng.uniform(1.0, 6.5, (m, 2))
    vel = rng.uniform(-0.5, 0.5, (m, 2))
    pref = rng.uniform(-0.6, 0.6, (m, 2))
    rad, ms = np.full(m, 0.5), np.full(m, 0.6)
    seg, ovf = split_segments(T(aabbs), torch.ones(3, dtype=torch.bool))
    assert not bool(ovf)
    e2, eb = torch.zeros((0, 2), dtype=torch.float64), torch.zeros(
        (0,), dtype=torch.bool)
    got_pos, got_vel = orca.orca_step(
        T(pos), T(vel), T(pref), T(rad), T(ms),
        torch.ones(m, dtype=torch.bool), e2, e2, eb,
        orca.OrcaConfig(time_step=0.4, max_obs_segments=32), seg)
    want_pos, want_vel = orca_oracle.orca_oracle_step(
        pos, vel, pref, rad, ms, np.zeros((0, 2)), np.zeros((0, 2)), aabbs,
        time_step=0.4, split=True)
    np.testing.assert_allclose(got_vel.numpy(), want_vel, atol=1e-8)
    np.testing.assert_allclose(got_pos.numpy(), want_pos, atol=1e-8)
    seg_j, _ = jsplit(jnp.asarray(aabbs), jnp.ones(3, bool))
    _, jv = jax_orca_step(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(pref),
        jnp.asarray(rad), jnp.asarray(ms), jnp.ones(m, bool),
        jnp.zeros((0, 2)), jnp.zeros((0, 2)), jnp.zeros((0,), bool),
        JaxOrcaConfig(time_step=0.4, max_obs_segments=32), seg_j)
    np.testing.assert_allclose(got_vel.numpy(), np.asarray(jv), atol=1e-9)
