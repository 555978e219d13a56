"""The port's LQT solvers (``img_env_tpu_torch.mpc.lqr``) against the JAX
package's on the same random problems (``tests/test_lqr.py``'s generator,
numpy from a seed).

float64: the sequential and associative-scan backward passes, the gains
and the rollout agree with JAX's within 1e-8 (measured ~1e-14; the port
builds ``jax.lax.associative_scan``'s combine tree, so the rounding is the
reference's).  float32: within 1e-4 of each output's largest entry
(measured <= 2e-6 relative): torch's LU solves and matmuls round in
another order than XLA's.
"""

import jax
import numpy as np
import pytest
import torch

from img_env_tpu.mpc import lqr as jlqr
from img_env_tpu_torch.mpc import lqr
from tests.test_lqr import random_problem, total_cost


def _problems(seed, h, batch=None, dtype=np.float64):
    rng = np.random.default_rng(seed)
    if batch is None:
        return [np.asarray(x, dtype) for x in random_problem(rng, h=h)]
    parts = [random_problem(rng, h=h) for _ in range(batch)]
    return [np.stack([np.asarray(p[i], dtype) for p in parts])
            for i in range(9)]


def _port(arrays):
    return lqr.LqtProblem(*(torch.as_tensor(np.array(a)) for a in arrays))


def _jax(arrays):
    return jlqr.LqtProblem(*(jax.numpy.asarray(a) for a in arrays))


@pytest.mark.parametrize("solver", ["lqt_backward_seq", "lqt_backward_assoc"])
@pytest.mark.parametrize("h", [1, 2, 9, 12, 13, 64])
def test_backward_matches_jax_f64(solver, h):
    """S, s, K and d of every step; odd, even and one-step horizons walk
    every branch of the combine tree."""
    arrays = _problems(h, h)
    with jax.enable_x64(True):
        want = jax.jit(getattr(jlqr, solver))(_jax(arrays))
    got = getattr(lqr, solver)(_port(arrays))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8,
                                   atol=1e-8)


def test_assoc_matches_seq_and_is_optimal():
    """The port's own invariants (test_lqr.py's): the two passes agree, and
    perturbing any control of the LQT rollout cannot lower the cost."""
    arrays = _problems(3, 6)
    p = _port(arrays)
    seq, assoc = lqr.lqt_backward_seq(p), lqr.lqt_backward_assoc(p)
    for a, b in zip(seq, assoc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8, atol=1e-8)
    x0 = torch.as_tensor(np.random.default_rng(4).normal(size=3))
    xs, us = lqr.lqt_rollout(p, x0, seq[2], seq[3])
    jp = _jax(arrays)
    base = total_cost(jp, xs.numpy(), us.numpy())   # numpy sums
    for k in (0, 3, 5):
        for j in range(2):
            for eps in (1e-3, -1e-3):
                u = us.clone()
                u[k, j] += eps
                x = [x0]
                for t in range(6):
                    x.append(p.F[t] @ x[-1] + p.L[t] @ u[t] + p.c[t])
                assert total_cost(jp, torch.stack(x).numpy(),
                                  u.numpy()) >= base - 1e-9


def test_batched_robots_and_rollout_match_jax():
    """A batch of 4 problems (one per robot) in one call against JAX per
    problem, and the affine-policy rollout, float64."""
    arrays = _problems(7, 12, batch=4)
    got = lqr.lqt_backward_assoc(_port(arrays))
    x0 = np.random.default_rng(8).normal(size=(4, 3))
    xs, us = lqr.lqt_rollout(_port(arrays), torch.as_tensor(x0), got[2],
                             got[3])
    with jax.enable_x64(True):
        for i in range(4):
            jp = _jax([a[i] for a in arrays])
            want = jax.jit(jlqr.lqt_backward_assoc)(jp)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g[i].numpy(), np.asarray(w),
                                           rtol=1e-8, atol=1e-8)
            wx, wu = jax.jit(jlqr.lqt_rollout)(
                jp, jax.numpy.asarray(x0[i]), want[2], want[3])
            np.testing.assert_allclose(xs[i].numpy(), np.asarray(wx),
                                       rtol=1e-8, atol=1e-8)
            np.testing.assert_allclose(us[i].numpy(), np.asarray(wu),
                                       rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("solver", ["lqt_backward_seq", "lqt_backward_assoc"])
def test_backward_matches_jax_f32(solver):
    """float32, H = 12 as the iLQR act runs it, against the jitted JAX
    pass: within 1e-4 of each output's largest entry."""
    arrays = _problems(11, 12, dtype=np.float32)
    with jax.enable_x64(False):
        want = jax.jit(getattr(jlqr, solver))(_jax(arrays))
    got = getattr(lqr, solver)(_port(arrays))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
