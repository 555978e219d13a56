"""Speed limiter and robot kinematics of the torch port vs the JAX package,
in float64 (atol 1e-12) and float32 (jitted JAX like the production
program) bit for bit: glibc's sin/cos, XLA's contractions and its
products with a constant's reciprocal (ops/f32.py); arrival flags
exactly."""

import jax
import numpy as np
import pytest
import torch

from img_env_tpu.config import SpeedLimiterConfig as JLimCfg
from img_env_tpu.dynamics import kinematics as jkin
from img_env_tpu.dynamics import limiter as jlim
from img_env_tpu_torch.config import SpeedLimiterConfig
from img_env_tpu_torch.dynamics import kinematics, limiter

LIMITS = dict(has_velocity_limits=True, has_acceleration_limits=True,
              has_jerk_limits=True, min_velocity=-0.3, max_velocity=0.55,
              min_acceleration=-1.3, max_acceleration=0.9, min_jerk=-2.5,
              max_jerk=1.7)
TOL = {np.float64: 1e-12, np.float32: 0.0}


def _commands(rng, n, dtype):
    v = rng.uniform(-0.8, 0.8, n)
    v0 = rng.uniform(-0.8, 0.8, n)
    v1 = rng.uniform(-0.8, 0.8, n)
    v[::7], v0[::5], v1[::3] = 0.0, 0.0, 0.0      # exact zeros: C++ sign()
    v0[1::6] = -v[1::6]                            # sign crossings
    return [a.astype(dtype) for a in (v, v0, v1)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("limits", [False, True])
def test_limit_command(rng, dtype, limits):
    cfg_kw = LIMITS if limits else {}
    pj = jlim.LimiterParams.from_config(JLimCfg(**cfg_kw))
    pt = limiter.LimiterParams.from_config(SpeedLimiterConfig(**cfg_kw))
    v, v0, v1 = _commands(rng, 400, dtype)
    with jax.enable_x64(dtype == np.float64):
        want = jax.jit(lambda a, b, c: jlim.limit_command(
            pj, a, b, c, 0.4))(v, v0, v1)
    got = limiter.limit_command(pt, torch.as_tensor(v), torch.as_tensor(v0),
                                torch.as_tensor(v1), 0.4)
    assert got.dtype == torch.from_numpy(v).dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ktype", ["diff", "omni"])
def test_batched_robot_cmd(rng, dtype, ktype):
    n = 64
    poses = np.stack([rng.uniform(1, 9, n), rng.uniform(1, 9, n),
                      rng.uniform(-3.1, 3.1, n)], -1).astype(dtype)
    goals = (poses[:, :2] + rng.uniform(-0.6, 0.6, (n, 2))).astype(dtype)
    vw0 = rng.uniform(-0.5, 0.5, (n, 2)).astype(dtype)
    vw1 = rng.uniform(-0.5, 0.5, (n, 2)).astype(dtype)
    vel = rng.uniform(-0.5, 0.5, (n, 2)).astype(dtype)
    v, w, vy = (rng.uniform(-0.6, 0.6, n).astype(dtype) for _ in range(3))
    w[::9] = 0.0                                  # straight-line branch
    alive = rng.random(n) > 0.2
    lim = JLimCfg(**LIMITS)
    pj = jlim.LimiterParams.from_config(lim)
    pt = limiter.LimiterParams.from_config(SpeedLimiterConfig(**LIMITS))
    args = (poses, goals, vw0, vw1, vel, v, w, vy, alive)
    with jax.enable_x64(dtype == np.float64):
        want = jax.jit(lambda *a: _masked_cmd(jkin.batched_robot_cmd, a)(
            pj, pj, 0.4, 9, ktype))(*args)
    got = _masked_cmd(kinematics.batched_robot_cmd,
                      [torch.as_tensor(a) for a in args])(
        pt, pt, 0.4, 9, ktype)
    for g, wnt in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt),
                                   atol=TOL[dtype], rtol=0)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert got[4].any() and not got[4].all()


def _masked_cmd(fn, args):
    """``fn`` with the commands masked by ``alive`` first, as both
    packages' ``NavEnv.advance_fn`` calls it: XLA's fusion of the new
    yaw's multiply-add depends on that mask (kinematics.batched_robot_cmd)."""
    poses, goals, vw0, vw1, vel, v, w, vy, alive = args
    where = torch.where if isinstance(v, torch.Tensor) else jax.numpy.where
    cmd = [where(alive, x, 0.0 * x) for x in (v, w, vy)]
    return lambda *rest: fn(poses, goals, vw0, vw1, vel, *cmd, alive, *rest)


def _jax_cmd(args, ktype):
    p = jlim.LimiterParams.from_config(JLimCfg())
    with jax.enable_x64(False):
        return jax.jit(lambda *a: _masked_cmd(jkin.batched_robot_cmd, a)(
            p, p, 0.4, 9, ktype))(*args)


@pytest.mark.parametrize("ktype", ["diff", "omni"])
def test_robot_cmd_float32_exact_at_tiny_turn_rates(rng, ktype):
    """|w| < 1e-3, where the arc's v/w terms cancel and one ulp of a sin or
    cos moves the pose by up to ~1e-3 m: float32 poses, world velocities
    and arrivals bit-equal to the jitted JAX function, and goals placed
    within a few ulps of the 0.3 m arrival radius of the final pose, so
    that the distance's contraction decides arrivals."""
    n = 4000
    f = np.float32
    poses = np.stack([rng.uniform(1, 9, n), rng.uniform(1, 9, n),
                      rng.uniform(-3.1, 3.1, n)], -1).astype(f)
    v, vy = (rng.uniform(-0.6, 0.6, n).astype(f) for _ in range(2))
    w = (rng.uniform(-1e-3, 1e-3, n) * 10.0 ** -rng.integers(0, 4, n)
         ).astype(f)
    z = np.zeros((n, 2), f)
    alive = np.ones(n, bool)
    far = (poses[:, :2] + 5.0).astype(f)
    final = np.asarray(_jax_cmd((poses, far, z, z, z, v, w, vy, alive),
                                ktype)[0])
    phi = rng.uniform(0, 2 * np.pi, n)
    goals = (final[:, :2] + 0.3 * np.stack([np.cos(phi), np.sin(phi)], -1)
             + rng.uniform(-2e-6, 2e-6, (n, 2))).astype(f)
    args = (poses, goals, z, z, z, v, w, vy, alive)
    want = _jax_cmd(args, ktype)
    lim = limiter.LimiterParams.from_config(SpeedLimiterConfig())
    got = _masked_cmd(kinematics.batched_robot_cmd,
                      [torch.as_tensor(a) for a in args])(
        lim, lim, 0.4, 9, ktype)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    assert got[4].any() and not got[4].all()
