"""Time-varying LQR/LQT solvers (torch port of ``img_env_tpu.mpc.lqr``):
sequential Riccati and parallel-scan Riccati.

  * ``lqt_backward_seq``  — the classic reverse recursion;
  * ``lqt_backward_assoc``— Särkkä & García-Fernández-style temporal
    parallelization: the per-step conditional value functions form a
    (min-plus) semigroup with elements (A, b, C, eta, J), combined by
    ``_associative_scan`` in O(log H) depth.

Both return the value-function pairs (S_k, s_k) with
V_k(x) = 0.5 x'S_k x - s_k'x + const, from which the affine policy
u_k = -K_k x - d_k is recovered pointwise (vectorized over the horizon).

Problem form (k = 0..H-1):
    x_{k+1} = F_k x_k + L_k u_k + c_k
    cost    = sum_k 0.5 x'Q_k x + q_k'x + 0.5 u'R_k u + r_k'u
              + 0.5 x_H'Q_H x_H + q_H'x_H

Every tensor may carry leading batch dimensions (robots): F [*B, H, n, n],
q [*B, H, n], QT [*B, n, n], qT [*B, n].  The horizon is the axis before
each tensor's matrix or vector dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LqtProblem(NamedTuple):
    F: torch.Tensor   # [*B,H,n,n]
    L: torch.Tensor   # [*B,H,n,m]
    c: torch.Tensor   # [*B,H,n]
    Q: torch.Tensor   # [*B,H,n,n] state cost (stage)
    q: torch.Tensor   # [*B,H,n]
    R: torch.Tensor   # [*B,H,m,m]
    r: torch.Tensor   # [*B,H,m]
    QT: torch.Tensor  # [*B,n,n] terminal
    qT: torch.Tensor  # [*B,n]


def _solve(mat, rhs):
    """``mat^-1 rhs`` for a matrix right-hand side [..., n, k].  No error
    check, so no host sync on the card: a singular system gives inf/nan
    in place, as ``jnp.linalg.solve`` does."""
    return torch.linalg.solve_ex(mat, rhs, check_errors=False)[0]


def _solve_vec(mat, vec):
    return _solve(mat, vec[..., None])[..., 0]


def _mv(mat, vec):
    return (mat @ vec[..., None])[..., 0]


def _t(mat):
    return mat.transpose(-1, -2)


# ---------------------------------------------------------------------------
# Sequential backward pass
# ---------------------------------------------------------------------------


def lqt_backward_seq(p: LqtProblem):
    """Reverse Riccati recursion.  Returns (S [*B,H+1,n,n], s [*B,H+1,n],
    K [*B,H,m,n], d [*B,H,m])."""
    h = p.F.shape[-3]
    S_next, s_next = p.QT, -p.qT
    Ss, ss, Ks, ds = [], [], [], []
    for k in reversed(range(h)):
        F, L, c = p.F[..., k, :, :], p.L[..., k, :, :], p.c[..., k, :]
        Q, q = p.Q[..., k, :, :], p.q[..., k, :]
        R, r = p.R[..., k, :, :], p.r[..., k, :]
        # u* = -(R + L'S'L)^{-1} (L'(S'(Fx + c) - s') + r)
        H_uu = R + _t(L) @ S_next @ L
        G = _t(L) @ S_next @ F                               # [m,n]
        hv = _mv(_t(L), _mv(S_next, c) - s_next) + r         # [m]
        K = _solve(H_uu, G)
        d = _solve_vec(H_uu, hv)
        Fc = F - L @ K
        S = Q + _t(F) @ S_next @ Fc
        s = -q + _mv(_t(K), r) + _mv(_t(Fc), s_next - _mv(S_next, c))
        S = 0.5 * (S + _t(S))
        S_next, s_next = S, s
        Ss.append(S)
        ss.append(s)
        Ks.append(K)
        ds.append(d)
    S_all = torch.stack(Ss[::-1] + [p.QT], dim=-3)
    s_all = torch.stack(ss[::-1] + [-p.qT], dim=-2)
    return S_all, s_all, torch.stack(Ks[::-1], -3), torch.stack(ds[::-1], -2)


# ---------------------------------------------------------------------------
# Parallel (associative scan) backward pass
# ---------------------------------------------------------------------------


class _Elem(NamedTuple):
    A: torch.Tensor
    b: torch.Tensor
    C: torch.Tensor
    eta: torch.Tensor
    J: torch.Tensor


# trailing (non-scan) dimensions of each _Elem field: A, C, J are matrices
_ND = _Elem(A=2, b=1, C=2, eta=1, J=2)


def _slice(e: _Elem, sl: slice) -> _Elem:
    """``sl`` along the scan axis of every field."""
    return _Elem(*(x[(Ellipsis, sl) + (slice(None),) * nd]
                   for x, nd in zip(e, _ND)))


def _cat(a: _Elem, b: _Elem) -> _Elem:
    return _Elem(*(torch.cat([x, y], dim=-1 - nd)
                   for x, y, nd in zip(a, b, _ND)))


def _interleave(a: _Elem, b: _Elem) -> _Elem:
    """a0, b0, a1, b1, ... along the scan axis (len(a) is len(b) or one
    more), as ``jax.lax`` interleaves the even and odd results."""
    out = []
    for x, y, nd in zip(a, b, _ND):
        ax = x.dim() - 1 - nd
        na, nb = x.shape[ax], y.shape[ax]
        shape = list(x.shape)
        shape[ax] = na + nb
        z = x.new_empty(shape)
        z[(Ellipsis, slice(0, None, 2)) + (slice(None),) * nd] = x
        z[(Ellipsis, slice(1, None, 2)) + (slice(None),) * nd] = y
        out.append(z)
    return _Elem(*out)


def _associative_scan(fn, elems: _Elem) -> _Elem:
    """Inclusive scan of ``fn`` along the scan axis with the combine tree
    of ``jax.lax.associative_scan`` (reduce adjacent pairs, recurse,
    combine the odd results with the even elements, interleave), so that
    the rounding is the reference's."""
    num = elems.A.shape[-3]
    if num < 2:
        return elems
    reduced = fn(_slice(elems, slice(0, -1, 2)), _slice(elems, slice(1, None, 2)))
    odd = _associative_scan(fn, reduced)
    if num % 2 == 0:
        even = fn(_slice(odd, slice(0, -1)), _slice(elems, slice(2, None, 2)))
    else:
        even = fn(odd, _slice(elems, slice(2, None, 2)))
    even = _cat(_slice(elems, slice(0, 1)), even)
    return _interleave(even, odd)


def _combine(ej: _Elem, ei: _Elem) -> _Elem:
    """Compose conditional value functions: result spans ei's interval first.

    Operands arrive reversed (suffix scan runs on the reversed sequence), so
    ``ei`` is the earlier interval, ``ej`` the later one.
    """
    n = ei.A.shape[-1]
    I = torch.eye(n, dtype=ei.A.dtype, device=ei.A.device)
    D = I + ei.C @ ej.J                              # [n,n]
    Dinv_Ai = _solve(D, ei.A)
    Dinv_b = _solve(D, ei.b[..., None] + ei.C @ ej.eta[..., None])
    Dinv_C = _solve(D, ei.C)
    Dt = I + ej.J @ ei.C
    Dt_inv_eta = _solve(Dt, ej.eta[..., None] - ej.J @ ei.b[..., None])
    Dt_inv_J = _solve(Dt, ej.J)
    A = ej.A @ Dinv_Ai
    b = (ej.A @ Dinv_b)[..., 0] + ej.b
    C = ej.A @ Dinv_C @ _t(ej.A) + ej.C
    eta = (_t(ei.A) @ Dt_inv_eta)[..., 0] + ei.eta
    J = _t(ei.A) @ Dt_inv_J @ ei.A + ei.J
    return _Elem(A, b, C, eta, J)


def lqt_backward_assoc(p: LqtProblem):
    """O(log H)-depth Riccati via the associative scan.  Returns (S, s, K,
    d) equal (to fp tolerance) to ``lqt_backward_seq``'s."""
    n = p.F.shape[-1]
    batch = p.F.shape[:-3]
    Rinv_Lt = _solve(p.R, _t(p.L))                              # [H,m,n]
    Rinv_r = _solve_vec(p.R, p.r)                               # [H,m]
    C = p.L @ Rinv_Lt                                           # [H,n,n]
    b = p.c - _mv(p.L, Rinv_r)
    elems = _Elem(A=p.F, b=b, C=C, eta=-p.q, J=p.Q)
    zeros = p.F.new_zeros(batch + (1, n, n))
    term = _Elem(A=zeros, b=p.F.new_zeros(batch + (1, n)), C=zeros,
                 eta=-p.qT[..., None, :], J=p.QT[..., None, :, :])
    seq = _cat(elems, term)
    rev = _Elem(*(torch.flip(x, [-1 - nd]) for x, nd in zip(seq, _ND)))
    scanned = _associative_scan(_combine, rev)
    S_all = torch.flip(scanned.J, [-3])          # [H+1,n,n]
    s_all = torch.flip(scanned.eta, [-2])        # [H+1,n]

    # recover gains pointwise from (S_{k+1}, s_{k+1})
    S1, s1 = S_all[..., 1:, :, :], s_all[..., 1:, :]
    Lt = _t(p.L)
    H_uu = p.R + Lt @ S1 @ p.L
    G = Lt @ S1 @ p.F
    hvec = (Lt @ (S1 @ p.c[..., None] - s1[..., None]))[..., 0] + p.r
    K = _solve(H_uu, G)
    d = _solve_vec(H_uu, hvec)
    return S_all, s_all, K, d


def lqt_rollout(p: LqtProblem, x0, K, d):
    """Forward pass with the affine policy; returns (xs [*B,H+1,n],
    us [*B,H,m])."""
    x = x0
    xs, us = [x0], []
    for k in range(p.F.shape[-3]):
        u = -_mv(K[..., k, :, :], x) - d[..., k, :]
        x = (_mv(p.F[..., k, :, :], x) + _mv(p.L[..., k, :, :], u)
             + p.c[..., k, :])
        xs.append(x)
        us.append(u)
    return torch.stack(xs, -2), torch.stack(us, -2)
