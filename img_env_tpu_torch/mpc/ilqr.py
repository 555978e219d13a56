"""iLQR over the smooth unicycle dynamics with parallel-scan Riccati (torch
port of ``img_env_tpu.mpc.ilqr``).

The derivative-based half of the MPC engine: linearize the dynamics with
autodiff, Gauss-Newton-quadraticize the smooth planning cost, solve the
time-varying LQT backward pass with the O(log H) associative scan
(mpc/lqr.py), forward-roll a batched line search over the step sizes, and
iterate a fixed number of times (no data-dependent control flow, so no
host sync but for the eigendecompositions' error checks on the card:
three a Gauss-Newton iteration).

``vmap`` over robots becomes a leading robot dimension: every robot's
problem rides one batch.  The Jacobians and Hessians come from
``torch.func``: forward mode (``jvp``) vmapped over the input directions,
as ``jax.jacfwd``, and the Hessian forward over reverse (``grad``), as
``jax.hessian``; robots and horizon steps stay batch dimensions of every
tensor, since each item's cost and step depend on its own inputs only.
(A per-item ``vmap`` would make each item's values 0-d tensors, whose
forward-mode tangents torch promotes to float64 when they meet a Python
scalar.)  Each call differentiates with respect to the stacked [x, u],
whose columns are the reference's separate derivatives.

Dynamics use a sinc-form arc step so gradients are well-defined at w = 0
(the sim's exact-arc branch divides by w; both agree to machine precision
away from 0).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch
from torch.func import grad, jvp, vmap

from img_env_tpu_torch.mpc.cost import (
    CostWeights,
    WorldCost,
    static_distance_smooth,
)
from img_env_tpu_torch.mpc.lqr import LqtProblem, lqt_backward_assoc
from img_env_tpu_torch.ops.raster import div_const
from img_env_tpu_torch.utils import trace


class IlqrConfig(NamedTuple):
    horizon: int = 16
    iters: int = 8
    mu: float = 1e-3                 # Levenberg regularization on Quu
    alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.03)
    v_range: Tuple[float, float] = (0.0, 0.6)
    w_range: Tuple[float, float] = (-0.9, 0.9)


def smooth_step(x, u, dt: float):
    """x=[px,py,yaw] [..., 3], u=[v,w] [..., 2] -> next x via the arc
    integral in sinc form.

    px' = px + v/w (sin(th+w dt) - sin th) = px + v dt S(w dt), with
    S(a) = (sin(th+a) - sin(th)) / a computed stably through the midpoint
    identity S = sinc(a/2) * cos(th + a/2).  Both ``where``s stay: without
    the inner one, autodiff through the untaken branch gives NaN at w = 0.
    """
    th, v, w = x[..., 2], u[..., 0], u[..., 1]
    a = w * dt
    half = 0.5 * a
    sinc = torch.where(torch.abs(half) < 1e-6,
                       1.0 - div_const(half * half, 6.0),
                       torch.sin(half) / torch.where(
                           half == 0, torch.ones_like(half), half))
    dx = v * dt * sinc * torch.cos(th + half)
    dy = v * dt * sinc * torch.sin(th + half)
    return torch.stack([x[..., 0] + dx, x[..., 1] + dy, th + a], dim=-1)


def _softplus(x):
    """``jax.nn.softplus``, logaddexp(x, 0), in the reference's form
    max(x, 0) + log1p(exp(-|x|)), whose derivatives are finite everywhere.
    torch's softplus returns x above its threshold (a gradient of exactly
    1 and a Hessian of 0 there); the Hessian of ``torch.logaddexp`` is
    inf/inf = NaN where the hinge is far outside its band."""
    return (torch.maximum(x, x.new_zeros(()))
            + torch.log1p(torch.exp(-torch.abs(x))))


def _stage_cost(wc: WorldCost, w8: CostWeights, goal, scene, avoid_t,
                avoid_r, x, u):
    """Smooth stage cost of states x [..., 3] and controls u [..., 2]:
    goal [..., 2], scene (broadcastable to x[..., 0]), this step's
    avoidance set avoid_t [..., M, 2] with radii avoid_r [..., M]."""
    xy = x[..., :2]
    goal_d = ((goal - xy) ** 2).sum(-1)
    sd = static_distance_smooth(wc, xy, scene) - wc.robot_radius
    hinge = _softplus((w8.safety_dist - sd) * 8.0) / 8.0
    cost = w8.goal * goal_d + w8.clearance * hinge ** 2 * 4.0
    if avoid_t.shape[-2]:
        # an empty set is +inf away: its hinge is exactly 0
        pd = (torch.sqrt(((xy[..., None, :] - avoid_t) ** 2).sum(-1))
              - avoid_r).amin(-1) - wc.robot_radius
        ped_hinge = _softplus((w8.ped_safety - pd) * 8.0) / 8.0
        cost = cost + w8.ped_weight * ped_hinge ** 2
    return cost + w8.effort_v * u[..., 0] ** 2 + w8.effort_w * u[..., 1] ** 2


def _terminal_cost(w8: CostWeights, goal, x):
    return w8.terminal_goal * ((goal - x[..., :2]) ** 2).sum(-1)


def _jacobian(f, z):
    """(f(z), per-item Jacobian) of an itemwise f: z [..., D] -> [..., P]
    (every item's outputs depend on its own inputs only), forward mode as
    ``jax.jacfwd``: one ``jvp`` per input dimension, vmapped over the D
    directions; the items stay a batch dimension of every tensor.
    Returns f(z) and [..., P, D]."""
    d = z.shape[-1]
    basis = torch.eye(d, dtype=z.dtype, device=z.device)
    basis = basis.reshape((d,) + (1,) * (z.dim() - 1) + (d,)).expand(
        (d,) + z.shape)
    out, tangents = vmap(lambda t: jvp(f, (z,), (t,)),
                         out_dims=(None, 0))(basis)
    return out, torch.movedim(tangents, 0, -1)


def _grad_hessian(f, z):
    """Per-item gradient [..., D] and Hessian [..., D, D] of an itemwise
    scalar f (z [..., D] -> [...]): the Hessian is forward over reverse,
    as ``jax.hessian``.  The gradient of the sum is each item's own."""
    return _jacobian(grad(lambda z: f(z).sum()), z)


def _psd(mat, floor: float, shift=None):
    """Symmetrize (then add ``shift``), and floor the eigenvalues: the
    Gauss-Newton projection."""
    mat = 0.5 * (mat + mat.transpose(-1, -2))
    if shift is not None:
        mat = mat + shift
    ev, vec = torch.linalg.eigh(mat)
    return (vec * torch.clamp(ev, min=floor)[..., None, :]) @ vec.transpose(
        -1, -2)


def _clip(u, cfg: IlqrConfig):
    return torch.stack([u[..., 0].clamp(cfg.v_range[0], cfg.v_range[1]),
                        u[..., 1].clamp(cfg.w_range[0], cfg.w_range[1])], -1)


@functools.lru_cache(maxsize=8)
def _alphas(alphas, dtype, device):
    """The line search's step sizes as a tensor, copied to the device once
    (a copy from the host's memory is a host sync)."""
    return torch.tensor(alphas, dtype=dtype, device=device)


def _solve(x0s, goals, us_init, wc: WorldCost, avoid_traj, avoid_r,
           cfg: IlqrConfig, w8: CostWeights, dt: float):
    """iLQR for N robots in one batch: x0s [N,3], goals [N,2], us_init
    [N,H,2], each robot's avoidance tracks avoid_traj [N,Hp,M,2] and radii
    avoid_r [N,M]; robot i reads the EDT of scene ``wc.scene[i]``.
    Returns (us [N,H,2], xs [N,H+1,3], cost [N])."""
    n, h = x0s.shape[0], cfg.horizon
    dtype, dev = x0s.dtype, x0s.device
    t_idx = torch.clamp(torch.arange(h, device=dev),
                        max=avoid_traj.shape[1] - 1)
    avoid_h = avoid_traj[:, t_idx]                            # [N,H,M,2]
    alphas = _alphas(cfg.alphas, dtype, dev)
    eye_m = torch.eye(2, dtype=dtype, device=dev)

    def stage(z):
        return _stage_cost(wc, w8, goals[:, None], wc.scene[:, None],
                           avoid_h, avoid_r[:, None], z[..., :3], z[..., 3:])

    def rollout(us):
        xs = [x0s]
        for k in range(h):
            xs.append(smooth_step(xs[-1], us[:, k], dt))
        return torch.stack(xs, 1)

    def total_cost(xs, us):
        """xs [..., N, H+1, 3], us [..., N, H, 2] -> [..., N]."""
        cs = _stage_cost(wc, w8, goals[:, None], wc.scene[:, None],
                         avoid_h, avoid_r[:, None], xs[..., :-1, :], us)
        return cs.sum(-1) + _terminal_cost(w8, goals, xs[..., -1, :])

    us = us_init
    best_cost = total_cost(rollout(us), us)
    for _ in range(cfg.iters):
        xs = rollout(us)
        x, xT = xs[:, :-1], xs[:, -1]
        z = torch.cat([x, us], -1)                            # [N,H,5]
        nxt, jac = _jacobian(
            lambda z: smooth_step(z[..., :3], z[..., 3:], dt), z)
        F, L = jac[..., :3], jac[..., 3:]                     # [N,H,3,*]
        c = nxt - ((F @ x[..., None])[..., 0] + (L @ us[..., None])[..., 0])
        g, hess = _grad_hessian(stage, z)
        Q = _psd(hess[..., :3, :3], 0.0)
        q = g[..., :3] - (Q @ x[..., None])[..., 0]
        R = _psd(hess[..., 3:, 3:], cfg.mu, cfg.mu * eye_m)
        r = g[..., 3:] - (R @ us[..., None])[..., 0]
        gT, QT = _grad_hessian(lambda x: _terminal_cost(w8, goals, x), xT)
        QT = _psd(QT, 0.0)
        qT = gT - (QT @ xT[..., None])[..., 0]
        p = LqtProblem(F=F, L=L, c=c, Q=Q, q=q, R=R, r=r, QT=QT, qT=qT)
        _, _, K, d = lqt_backward_assoc(p)

        # line search: every step size at once, [A, N, ...].  The LQT
        # solution is the absolute affine policy u = -K x - d; blend the
        # old open-loop controls toward it, evaluated closed-loop.
        a = alphas[:, None, None]
        x = x0s.expand(len(cfg.alphas), n, 3)
        xs_a, us_a = [x], []
        for k in range(h):
            u_lqr = -(K[:, k] @ x[..., None])[..., 0] - d[:, k]
            u = _clip(us[:, k] + a * (u_lqr - us[:, k]), cfg)
            x = smooth_step(x, u, dt)
            xs_a.append(x)
            us_a.append(u)
        us_cands = torch.stack(us_a, 2)                       # [A,N,H,2]
        costs = total_cost(torch.stack(xs_a, 2), us_cands)    # [A,N]
        best = torch.argmin(costs, 0)                         # first min
        cost_best = costs.gather(0, best[None])[0]
        us_best = us_cands.gather(
            0, best[None, :, None, None].expand(1, n, h, 2))[0]
        us = torch.where((cost_best < best_cost)[:, None, None], us_best, us)
        best_cost = torch.minimum(cost_best, best_cost)
    return us, rollout(us), best_cost


def ilqr_solve(x0, goal, us_init, wc: WorldCost, ped_traj, ped_r,
               cfg: IlqrConfig, w8: CostWeights = CostWeights(),
               dt: float = 0.4):
    """One robot: x0 [3], goal [2], us_init [H,2]; ``wc`` with ``scene``
    [1] (the robot's scene); ped_traj [H,M,2] (or [M,2]: static peds) and
    ped_r [M], the avoidance set.  Returns (us [H,2], xs [H+1,3], total
    cost)."""
    if ped_traj.dim() == 2:   # back-compat: [M,2] static peds -> frozen
        ped_traj = ped_traj[None].expand((cfg.horizon,) + ped_traj.shape)
    us, xs, cost = _solve(x0[None], goal[None], us_init[None], wc,
                          ped_traj[None], ped_r[None], cfg, w8, dt)
    return us[0], xs[0], cost[0]


@trace.spanned("mpc.solve")
def batched_ilqr(x0s, goals, us_inits, wc: WorldCost, ped_traj, ped_r,
                 cfg: IlqrConfig, w8: CostWeights = CostWeights(),
                 dt: float = 0.4, robot_traj=None, robot_r=None):
    """One iLQR solve per robot of S scenes (``wc.scene`` [N], the scenes'
    robots contiguous and equal in number), in one batch.  Returns (us
    [N,H,2], xs [N,H+1,3], costs [N]).

    ped_traj [S,H,M,2] / ped_r [M]: each robot avoids its scene's
    predicted peds.  robot_traj [H,N,2] / robot_r [N]: other-robot
    avoidance tracks; each robot avoids every robot of its scene, its own
    column at 1e6 (the reference's self-mask, ilqr.py:190-198)."""
    n = x0s.shape[0]
    avoid = ped_traj[wc.scene]                                # [N,H,M,2]
    avoid_r = ped_r[None].expand(n, ped_traj.shape[-2])
    if robot_traj is not None:
        s = int(wc.edt.shape[0])
        nps = n // s
        hp = robot_traj.shape[0]
        others = robot_traj.reshape(hp, s, nps, 2)[:, wc.scene]  # [H,N,k,2]
        own = torch.arange(n, device=x0s.device) % nps
        self_col = (torch.arange(nps, device=x0s.device)[None, :]
                    == own[:, None])                          # [N,k]
        others = torch.where(self_col[None, :, :, None], 1e6,
                             others).permute(1, 0, 2, 3)
        avoid = torch.cat([avoid, others], dim=2)
        avoid_r = torch.cat([avoid_r, robot_r.reshape(s, nps)[wc.scene]], 1)
    return _solve(x0s, goals, us_inits, wc, avoid, avoid_r, cfg, w8, dt)
