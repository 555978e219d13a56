"""Batched ORCA (RVO2) velocity solver (torch port of
``img_env_tpu.crowd.orca``).

Agents are a dimension of every tensor: the neighbour sets come from
masked pairwise distances and a stable sort, and the obstacle and agent
ORCA lines of all agents are built at once (Agent.cpp:72-434).  The 2D
linear programs (Agent.cpp:845-1002) keep RVO2's sequential semantics but
only their selection runs in order:

  * ``_lp1`` never reads the result that its caller carries, so the
    solution on every line ``i`` against the lines before it is computed
    for all ``i`` at once ([..., L, L] pairwise terms);
  * the lines, validity and optimisation direction that ``_lp3`` hands its
    inner ``linearProgram2`` depend only on ``i``, so those L inner
    programs are solved together, and in the same sweep as the main
    ``linearProgram2`` (their lp1 tables are [M, L, L, L]);
  * what stays sequential is a selection chain of a few tensor ops per
    constraint: which precomputed solution each step keeps.  The
    ``alreadyCovered`` prune of obstacle lines (Agent.cpp:86-107) is the
    same: its coverage tests are one [M, K, K] precompute, then a chain
    over the K slots.

Every function takes any leading batch shape: agents ``[..., M, ...]``,
segments ``[..., S, ...]``, beep sources ``[..., B, 2]``.  ``NavEnv``
solves the crowds of all its scenes in one call ``[scenes, M]``, each
scene against its own segments and neighbours; the MPC's 'orca' head
solves one population ``[M]``.  Sorts, gathers and reductions run along
the agent and slot axes, and every reduction of a solver element is an
``amin``, ``amax``, ``any``, stable sort or two-term sum, so a batch of
scenes solves each scene bit for bit as a separate call would.  (The
evacuation term sums a scene's B beep sources, in an order that no batch
shape can change while B <= 2, as with the ERVO configuration's robot.)

Reference behaviours kept (as in the JAX package, which its tests hold to
``img_env_tpu.oracle.orca_oracle``): agent parameters (0.5, 10, 5, 5, 0.5)
from rvoscene.h:57; clockwise rectangles (rvoscene.h:19-26); the kd-tree's
right-side insertion filter (KdTree.cpp:340); nearest-first obstacle
order; linearProgram2's first-failure freeze and linearProgram3's
projected re-optimisation.  Segments come split by RVO2's kd-tree build
(crowd/obstacle_split.py) at reset.  Sorts are stable, as ``jnp.argsort``
is: the invalid slots all sort at +inf and keep their index order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from img_env_tpu_torch.constants import RVO_EPSILON
from img_env_tpu_torch.utils import trace

INF = math.inf


def _det(ax, ay, bx, by):
    return ax * by - ay * bx


def _norm(vx, vy):
    n = torch.sqrt(vx * vx + vy * vy)
    n = torch.where(n == 0, 1.0, n)
    return vx / n, vy / n


def _dot(a, b):
    return (a * b).sum(-1)


def _perp(d):
    """(-d_y, d_x): ``_dot(p - r, _perp(d))`` is ``_det(d, p - r)`` with
    the same rounding (a sum of the two products, the second negated)."""
    return torch.stack([-d[..., 1], d[..., 0]], -1)


class OrcaConfig(NamedTuple):
    """Static solver configuration."""

    neighbor_dist: float = 0.5
    max_neighbors: int = 10
    time_horizon: float = 5.0
    time_horizon_obst: float = 5.0
    radius: float = 0.5
    time_step: float = 0.4
    max_obs_segments: int = 32   # splitting ~doubles segment counts


class Segments(NamedTuple):
    """Obstacle boundary segments of one scene (or of a batch of scenes,
    a leading axis on every field): per segment from vertex A to vertex
    B, the unit directions of it and of its neighbours on the boundary,
    and the convexity of both endpoints (RVOSimulator::addObstacle on the
    reference's clockwise rectangles)."""

    p1: torch.Tensor          # [...,S,2]
    p2: torch.Tensor          # [...,S,2]
    dir: torch.Tensor         # [...,S,2] unit dir of this segment
    prev_dir: torch.Tensor    # [...,S,2] unit dir of segment ending at p1
    next_dir: torch.Tensor    # [...,S,2] unit dir of segment starting at p2
    convex1: torch.Tensor     # [...,S] bool
    convex2: torch.Tensor     # [...,S] bool
    valid: torch.Tensor       # [...,S] bool


def segments_from_aabbs(aabb, valid) -> Segments:
    """Boundary segments of [..., O, 4] (pax,pay,pbx,pby) rectangles in
    the reference's vertex order (pa, pa.y->pb.y, pb, pb.y->pa.y),
    clockwise for pa < pb, so every vertex computes non-convex.  ``valid``
    [..., O] (or broadcast to it)."""
    pax, pay, pbx, pby = aabb.unbind(-1)
    v = torch.stack([torch.stack([pax, pay], -1), torch.stack([pax, pby], -1),
                     torch.stack([pbx, pby], -1), torch.stack([pbx, pay], -1)],
                    -2)                                  # [...,O,4,2]
    nxt = torch.roll(v, -1, -2)
    prv = torch.roll(v, 1, -2)
    d = nxt - v
    n = torch.sqrt((d * d).sum(-1, keepdim=True))
    dn = d / torch.where(n == 0, 1.0, n)
    # isConvex(vertex) = leftOf(prev, cur, next) >= 0, leftOf(a,b,c) =
    # det(a-c, b-a)
    a_min_c = prv - nxt
    b_min_a = v - prv
    conv = (a_min_c[..., 0] * b_min_a[..., 1]
            - a_min_c[..., 1] * b_min_a[..., 0]) >= 0.0
    lead = aabb.shape[:-2]
    flat = lambda x: x.reshape(lead + (-1,) + x.shape[aabb.dim():])
    return Segments(
        p1=flat(v), p2=flat(nxt), dir=flat(dn),
        prev_dir=flat(torch.roll(dn, 1, -2)),
        next_dir=flat(torch.roll(dn, -1, -2)),
        convex1=flat(conv), convex2=flat(torch.roll(conv, -1, -1)),
        valid=flat(valid[..., None].expand(conv.shape)))


def _take(x, idx):
    """x [...,M,S(,C)] at per-agent slots idx [...,M,K] -> [...,M,K(,C)]."""
    if x.dim() == idx.dim():
        return torch.gather(x, -1, idx)
    return torch.gather(x, -2, idx[..., None].expand(idx.shape
                                                     + x.shape[-1:]))


# ---------------------------------------------------------------------------
# ORCA line construction
# ---------------------------------------------------------------------------


def _obstacle_candidate_lines(pos, vel, cfg: OrcaConfig, seg: Segments):
    """Candidate ORCA line of every (agent, segment) pair: the obstacle
    branch of Agent::computeNewVelocity (Agent.cpp:443-...).  Returns
    [...,M,S] tensors (point, dir, has_line, rel1, rel2, dist_sq,
    inserted); ``inserted`` is the kd-tree's right-side filter."""
    r = cfg.radius
    inv = 1.0 / cfg.time_horizon_obst
    p = pos[..., :, None, :]
    v = vel[..., :, None, :]
    sg = lambda x: x[..., None, :, :]                   # [...,1,S,2]
    sb = lambda x: x[..., None, :]                      # [...,1,S]
    rel1 = sg(seg.p1) - p                                     # [...,M,S,2]
    rel2 = sg(seg.p2) - p
    seg_vec = sg(seg.p2 - seg.p1)                             # [...,1,S,2]
    seg_len_sq = _dot(seg_vec, seg_vec).clamp(min=1e-30)
    along = _dot(-rel1, seg_vec) / seg_len_sq
    closest = rel1 + along.clamp(0.0, 1.0)[..., None] * seg_vec
    dist_sq = _dot(closest, closest)
    # leftOf(p1, p2, pos) = det(p1 - pos, p2 - p1) (KdTree.cpp:336-346)
    left_of = _det(rel1[..., 0], rel1[..., 1], seg_vec[..., 0],
                   seg_vec[..., 1])
    inserted = sb(seg.valid) & (left_of < 0.0)

    dist_sq1 = _dot(rel1, rel1)
    dist_sq2 = _dot(rel2, rel2)
    r_sq = r * r
    s = along
    dline = -rel1 - s[..., None] * seg_vec
    dist_sq_line = _dot(dline, dline)

    # --- collision cases ---
    case_a = (s < 0.0) & (dist_sq1 <= r_sq)
    case_b = ~case_a & (s > 1.0) & (dist_sq2 <= r_sq)
    case_c = (~case_a & ~case_b & (s >= 0.0) & (s < 1.0)
              & (dist_sq_line <= r_sq))
    no_collision = ~(case_a | case_b | case_c)

    na1x, na1y = _norm(-rel1[..., 1], rel1[..., 0])
    na2x, na2y = _norm(-rel2[..., 1], rel2[..., 0])
    c1, c2 = sb(seg.convex1), sb(seg.convex2)
    sdir, nxt_dir = sg(seg.dir), sg(seg.next_dir)
    prv_dir = sg(seg.prev_dir)
    det_b = _det(rel2[..., 0], rel2[..., 1], nxt_dir[..., 0], nxt_dir[..., 1])
    line_a_ok = case_a & c1
    line_b_ok = case_b & c2 & (det_b >= 0.0)

    # --- oblique / usual legs ---
    d1 = (s < 0.0) & (dist_sq_line <= r_sq) & no_collision
    d2 = (s > 1.0) & (dist_sq_line <= r_sq) & no_collision & ~d1
    d3 = no_collision & ~d1 & ~d2
    d1_skip = d1 & ~c1
    d2_skip = d2 & ~c2

    def legs_from(relp, dsq):
        leg = torch.sqrt((dsq - r_sq).clamp(min=0.0))
        den = dsq.clamp(min=1e-30)
        x, y = relp[..., 0], relp[..., 1]
        left = torch.stack([(x * leg - y * r) / den, (x * r + y * leg) / den],
                           -1)
        right = torch.stack([(x * leg + y * r) / den,
                             (-x * r + y * leg) / den], -1)
        return left, right

    l1, r1 = legs_from(rel1, dist_sq1)
    l2, r2 = legs_from(rel2, dist_sq2)
    e = lambda b: b[..., None]
    left_leg = torch.where(e(d1), l1, torch.where(
        e(d2), l2, torch.where(e(c1), l1, -sdir)))
    right_leg = torch.where(e(d1), r1, torch.where(
        e(d2), r2, torch.where(e(c2), r2, sdir)))

    # effective obstacle endpoints after the oblique reassignments
    o1_is_2, o2_is_1 = d2, d1
    conv_o1 = torch.where(o1_is_2, c2, c1)
    conv_o2 = torch.where(o2_is_1, c1, c2)
    dir_o1 = torch.where(e(o1_is_2), nxt_dir, sdir)
    dir_o2 = torch.where(e(o2_is_1), sdir, nxt_dir)
    left_nb_dir = torch.where(e(o1_is_2), sdir, prv_dir)

    lf_det = _det(left_leg[..., 0], left_leg[..., 1], -left_nb_dir[..., 0],
                  -left_nb_dir[..., 1])
    left_foreign = conv_o1 & (lf_det >= 0.0)
    left_leg = torch.where(e(left_foreign), -left_nb_dir, left_leg)
    rf_det = _det(right_leg[..., 0], right_leg[..., 1], dir_o2[..., 0],
                  dir_o2[..., 1])
    right_foreign = conv_o2 & (rf_det <= 0.0)
    right_leg = torch.where(e(right_foreign), dir_o2, right_leg)

    left_cut = inv * torch.where(e(o1_is_2), rel2, rel1)
    right_cut = inv * torch.where(e(o2_is_1), rel1, rel2)
    cut_vec = right_cut - left_cut
    same_o = d1 | d2

    cv_sq = _dot(cut_vec, cut_vec).clamp(min=1e-30)
    t = torch.where(same_o, 0.5, _dot(v - left_cut, cut_vec) / cv_sq)
    t_left = _dot(v - left_cut, left_leg)
    t_right = _dot(v - right_cut, right_leg)

    proj_lcirc = (((t < 0.0) & (t_left < 0.0))
                  | (same_o & (t_left < 0.0) & (t_right < 0.0)))
    proj_rcirc = ~proj_lcirc & (t > 1.0) & (t_right < 0.0)

    uwlx, uwly = _norm(v[..., 0] - left_cut[..., 0],
                       v[..., 1] - left_cut[..., 1])
    uwrx, uwry = _norm(v[..., 0] - right_cut[..., 0],
                       v[..., 1] - right_cut[..., 1])

    sq = lambda x: _dot(x, x)
    d_cut = torch.where((t < 0.0) | (t > 1.0) | same_o, INF,
                        sq(v - (left_cut + t[..., None] * cut_vec)))
    d_left = torch.where(t_left < 0.0, INF,
                         sq(v - (left_cut + t_left[..., None] * left_leg)))
    d_right = torch.where(t_right < 0.0, INF,
                          sq(v - (right_cut + t_right[..., None] * right_leg)))

    pick_cut = (d_cut <= d_left) & (d_cut <= d_right)
    pick_left = ~pick_cut & (d_left <= d_right)

    # (direction, point) per case
    dir_lcirc = torch.stack([uwly, -uwlx], -1)
    dir_rcirc = torch.stack([uwry, -uwrx], -1)
    dir_cut = -dir_o1
    dir_right = -right_leg
    ri = r * inv
    pt_lcirc = left_cut + ri * torch.stack([uwlx, uwly], -1)
    pt_rcirc = right_cut + ri * torch.stack([uwrx, uwry], -1)
    pt_cut = left_cut + ri * _perp(dir_cut)
    pt_left = left_cut + ri * _perp(left_leg)
    pt_right = right_cut + ri * _perp(dir_right)

    d_line_ok = d3 | ((d1 | d2) & ~(d1_skip | d2_skip))
    has = torch.where(case_a, line_a_ok, torch.where(
        case_b, line_b_ok, torch.where(
            case_c, True, d_line_ok & torch.where(
                proj_lcirc | proj_rcirc | pick_cut, True,
                torch.where(pick_left, ~left_foreign, ~right_foreign)))))
    line_dir = torch.where(e(case_a), torch.stack([na1x, na1y], -1),
               torch.where(e(case_b), torch.stack([na2x, na2y], -1),
               torch.where(e(case_c), -sdir,
               torch.where(e(proj_lcirc), dir_lcirc,
               torch.where(e(proj_rcirc), dir_rcirc,
               torch.where(e(pick_cut), dir_cut,
               torch.where(e(pick_left), left_leg, dir_right)))))))
    line_pt = torch.where(e(case_a | case_b | case_c), 0.0,
              torch.where(e(proj_lcirc), pt_lcirc,
              torch.where(e(proj_rcirc), pt_rcirc,
              torch.where(e(pick_cut), pt_cut,
              torch.where(e(pick_left), pt_left, pt_right)))))
    return line_pt, line_dir, has & inserted, rel1, rel2, dist_sq, inserted


def obstacle_orca_lines(pos, vel, max_speed, cfg: OrcaConfig, seg: Segments):
    """The ``max_obs_segments`` nearest inserted segments -> pruned ORCA
    lines per agent: (pts [...,M,K,2], dirs [...,M,K,2], valid [...,M,K])
    nearest first, after the sequential alreadyCovered prune
    (Agent.cpp:86-107).  ``max_speed``: [...,M]."""
    k = cfg.max_obs_segments
    inv = 1.0 / cfg.time_horizon_obst
    r = cfg.radius
    pt, dr, has, rel1, rel2, dist_sq, inserted = _obstacle_candidate_lines(
        pos, vel, cfg, seg)
    range_sq = (cfg.time_horizon_obst * max_speed + r) ** 2
    cand = inserted & (dist_sq < range_sq[..., None])
    pad = k - pt.shape[-2]
    if pad > 0:   # fewer segments than slots: invalid entries at the end
        z2 = pt.new_zeros(pt.shape[:-2] + (pad, 2))
        zb = torch.zeros(z2.shape[:-1], dtype=torch.bool, device=pt.device)
        pt, dr, rel1, rel2 = (torch.cat([x, z2], -2)
                              for x in (pt, dr, rel1, rel2))
        has, cand = torch.cat([has, zb], -1), torch.cat([cand, zb], -1)
        dist_sq = torch.cat([dist_sq, torch.full_like(z2[..., 0], INF)], -1)
    idx = torch.argsort(torch.where(cand, dist_sq, INF), dim=-1,
                        stable=True)[..., :k]
    pt, dr, rel1, rel2 = (_take(x, idx) for x in (pt, dr, rel1, rel2))
    added = _take(has, idx) & _take(cand, idx)

    # alreadyCovered: slot i is dropped when both of its endpoints lie on
    # the far side of the line of an earlier kept slot j < i
    def beyond(rel):                                  # [..., M, i, j]
        return (_det(inv * rel[..., :, None, 0] - pt[..., None, :, 0],
                     inv * rel[..., :, None, 1] - pt[..., None, :, 1],
                     dr[..., None, :, 0], dr[..., None, :, 1])
                - inv * r >= -RVO_EPSILON)

    earlier = torch.ones((k, k), dtype=torch.bool,
                         device=pt.device).tril(-1)
    covers = beyond(rel1) & beyond(rel2) & earlier
    for i in range(1, k):
        added[..., i].gt_((covers[..., i, :] & added).any(-1))  # uncovered
    return pt, dr, added


def agent_orca_lines(pos, vel, cfg: OrcaConfig, all_pos, all_vel,
                     all_radius, all_valid):
    """ORCA half-planes of agent m (= row m of ``all_*``) against its
    nearest neighbours (Agent.cpp:352-420): (pts [...,M,Kn,2], dirs,
    valid [...,M,Kn]) with Kn = min(max_neighbors, A); ``all_*``
    [...,A(,2)]."""
    m, a = pos.shape[-2], all_pos.shape[-2]
    d = all_pos[..., None, :, :] - pos[..., :, None, :]
    dist_sq = _dot(d, d)                                      # [...,M,A]
    not_self = (torch.arange(a, device=pos.device)[None]
                != torch.arange(m, device=pos.device)[:, None])
    ok = (all_valid[..., None, :] & (dist_sq < cfg.neighbor_dist ** 2)
          & not_self)
    idx = torch.argsort(torch.where(ok, dist_sq, INF), dim=-1,
                        stable=True)[..., :cfg.max_neighbors]
    valid = torch.gather(ok, -1, idx)
    # every agent's row of the scene's table, at its neighbour slots
    nb = lambda x, c: _take(x.unsqueeze(-2 - c).expand(
        idx.shape[:-1] + x.shape[-1 - c:]), idx)

    rel_p = nb(all_pos, 1) - pos[..., :, None, :]
    rel_v = vel[..., :, None, :] - nb(all_vel, 1)
    dsq = _dot(rel_p, rel_p)
    comb_r = cfg.radius + nb(all_radius, 0)
    comb_r_sq = comb_r * comb_r
    inv_th = 1.0 / cfg.time_horizon
    inv_ts = 1.0 / cfg.time_step
    e = lambda b: b[..., None]

    # --- no-collision branch ---
    w_nc = rel_v - inv_th * rel_p
    w_len_sq = _dot(w_nc, w_nc)
    dot1 = _dot(w_nc, rel_p)
    cutoff = (dot1 < 0.0) & (dot1 * dot1 > comb_r_sq * w_len_sq)
    w_len = torch.sqrt(w_len_sq.clamp(min=1e-30))
    unit_w = w_nc / e(w_len)
    dir_cutoff = torch.stack([unit_w[..., 1], -unit_w[..., 0]], -1)
    u_cutoff = e(comb_r * inv_th - w_len) * unit_w

    leg = torch.sqrt((dsq - comb_r_sq).clamp(min=0.0))
    left = _det(rel_p[..., 0], rel_p[..., 1], w_nc[..., 0], w_nc[..., 1]) > 0.0
    den = dsq.clamp(min=1e-30)
    x, y = rel_p[..., 0], rel_p[..., 1]
    dir_left = torch.stack([(x * leg - y * comb_r) / den,
                            (x * comb_r + y * leg) / den], -1)
    dir_right = -torch.stack([(x * leg + y * comb_r) / den,
                              (-x * comb_r + y * leg) / den], -1)
    dir_leg = torch.where(e(left), dir_left, dir_right)
    u_leg = e(_dot(rel_v, dir_leg)) * dir_leg - rel_v

    # --- collision branch ---
    w_c = rel_v - inv_ts * rel_p
    w_c_len = torch.sqrt(_dot(w_c, w_c).clamp(min=1e-30))
    unit_wc = w_c / e(w_c_len)
    dir_coll = torch.stack([unit_wc[..., 1], -unit_wc[..., 0]], -1)
    u_coll = e(comb_r * inv_ts - w_c_len) * unit_wc

    colliding = e(dsq <= comb_r_sq)
    ldir = torch.where(colliding, dir_coll,
                       torch.where(e(cutoff), dir_cutoff, dir_leg))
    u = torch.where(colliding, u_coll, torch.where(e(cutoff), u_cutoff,
                                                   u_leg))
    return vel[..., :, None, :] + 0.5 * u, ldir, valid


# ---------------------------------------------------------------------------
# Linear programs
# ---------------------------------------------------------------------------


def _lp1_all(pts, dirs, valid, radius, opt, dir_opt: bool):
    """linearProgram1 (Agent.cpp:845-914) on every line i of [..., L]
    against the valid lines j < i: (result [..., L, 2], ok [..., L]).
    ``radius``: [...]; ``opt``: [..., 2]."""
    px, py = pts[..., 0], pts[..., 1]
    dx, dy = dirs[..., 0], dirs[..., 1]
    dot = _dot(pts, dirs)
    rad = radius[..., None]
    disc = dot * dot + rad * rad - _dot(pts, pts)
    sq = torch.sqrt(disc.clamp(min=0.0))
    t_left0, t_right0 = -dot - sq, -dot + sq

    n = pts.shape[-2]
    # [..., i, j]: line i against line j
    prior = valid[..., None, :] & torch.ones(
        (n, n), dtype=torch.bool, device=pts.device).tril(-1)
    denom = _det(dx[..., :, None], dy[..., :, None],
                 dx[..., None, :], dy[..., None, :])
    num = _det(dx[..., None, :], dy[..., None, :],
               px[..., :, None] - px[..., None, :],
               py[..., :, None] - py[..., None, :])
    parallel = denom.abs() <= RVO_EPSILON
    fail_par = (prior & parallel & (num < 0.0)).any(-1)
    tj = num / torch.where(parallel, 1.0, denom)
    bound = prior & ~parallel
    t_right = torch.where(bound & (denom >= 0.0), tj, INF).amin(-1)
    t_left = torch.where(bound & (denom < 0.0), tj, -INF).amax(-1)
    t_left = torch.maximum(t_left, t_left0)
    t_right = torch.minimum(t_right, t_right0)
    fail = (disc < 0.0) | fail_par | (t_left > t_right)
    o = opt[..., None, :]
    if dir_opt:
        t = torch.where(_dot(o, dirs) > 0.0, t_right, t_left)
    else:
        t = torch.minimum(torch.maximum(_dot(dirs, o - pts), t_left), t_right)
    return pts + t[..., None] * dirs, ~fail


def _lp2_chain(pts, nrm, newres, ok, init):
    """linearProgram2's sweep (Agent.cpp:916-947) over the L constraints
    of a batch of programs, given every lp1 solution (``newres``, ``ok``:
    [..., L, 2], [..., L]).  ``nrm``: the lines' normals ``_perp(dir)``,
    zero on invalid lines (never violated).  Returns (result [..., 2],
    fail index [...]: the first failing line, or L).

    A program runs while its threshold is 0: line j is violated when the
    result lies beyond it by more than the threshold.  The first violated
    line without an lp1 solution sets the threshold to +inf, which freezes
    the program (no later line can be violated)."""
    result = init
    thr = torch.zeros(init.shape[:-1], dtype=init.dtype, device=init.device)
    thr_after = torch.where(ok, 0.0, INF).to(init.dtype)
    thrs = []
    for j in range(pts.shape[-2]):
        upd = _dot(pts[..., j, :] - result, nrm[..., j, :]) > thr
        result = torch.where((upd & ok[..., j])[..., None], newres[..., j, :],
                             result)
        thr = torch.where(upd, thr_after[..., j], thr)
        thrs.append(thr)
    return result, (torch.stack(thrs, -1) == 0).sum(-1)


def solve_velocities(pts, dirs, valid, max_speed, pref_vel, num_obst: int):
    """The whole LP of computeNewVelocity for every agent: linearProgram2
    toward ``pref_vel`` and, from its first failure on, linearProgram3.
    pts/dirs [...,M,L,2], valid [...,M,L], max_speed [...,M], pref_vel
    [...,M,2]."""
    n = valid.shape[-1]
    dev = pts.device
    j = torch.arange(n, device=dev)
    e = lambda b: b[..., None]

    # main program: optimise toward pref_vel within the speed disc
    over = _dot(pref_vel, pref_vel) > max_speed * max_speed
    nrm = pref_vel / e(torch.sqrt(_dot(pref_vel, pref_vel)).clamp(min=1e-30))
    init_main = torch.where(e(over), nrm * e(max_speed), pref_vel)
    res_main, ok_main = _lp1_all(pts, dirs, valid, max_speed, pref_vel, False)

    # linearProgram3's program for line i ([..., M, i, j]): the obstacle
    # lines, and the valid agent lines j < i projected onto line i
    pi, di = pts[..., :, None, :], dirs[..., :, None, :]
    pj, dj = pts[..., None, :, :], dirs[..., None, :, :]
    src = ((j[None, :] >= num_obst) & (j[None, :] < j[:, None])
           & valid[..., None, :])
    determinant = _det(di[..., 0], di[..., 1], dj[..., 0], dj[..., 1])
    parallel = determinant.abs() <= RVO_EPSILON
    drop = src & parallel & (_dot(di, dj) > 0.0)
    tproj = _det(dj[..., 0], dj[..., 1], pi[..., 0] - pj[..., 0],
                 pi[..., 1] - pj[..., 1]) / torch.where(parallel, 1.0,
                                                       determinant)
    proj_pt = torch.where(e(parallel), 0.5 * (pi + pj),
                          pi + e(tproj) * di)
    dvec = dj - di
    proj_dir = dvec / e(torch.sqrt(_dot(dvec, dvec)).clamp(min=1e-30))
    new_pts = torch.where(e(src), proj_pt, pj)
    new_dirs = torch.where(e(src), proj_dir, dj)
    new_valid = (((j < num_obst) & valid)[..., None, :]) | (src & ~drop)
    opt = torch.stack([-dirs[..., 1], dirs[..., 0]], -1)     # [...,M,L,2]
    res_in, ok_in = _lp1_all(new_pts, new_dirs, new_valid,
                             max_speed[..., None].expand(valid.shape), opt,
                             True)

    # one sweep over the main program and the L inner ones: [..., M, 1+L]
    i_ax = valid.dim() - 1
    cat = lambda a, b: torch.cat([a.unsqueeze(i_ax), b], i_ax)
    all_valid = cat(valid, new_valid)
    all_pts = cat(pts, new_pts)
    all_nrm = torch.where(e(all_valid), _perp(cat(dirs, new_dirs)), 0.0)
    result, fail = _lp2_chain(
        all_pts, all_nrm, cat(res_main, res_in), cat(ok_main, ok_in),
        cat(init_main, opt * max_speed[..., None, None]))
    res2, ok2 = result[..., 1:, :], fail[..., 1:] >= n

    # linearProgram3 (Agent.cpp:949-1001) from the main program's first
    # failure: line i takes its inner solution when the current result
    # violates it by more than the distance reached so far
    out = result[..., 0, :]
    active = valid & (j >= fail[..., :1])
    nrm = _perp(dirs)
    dist2 = _dot(pts - res2, nrm)
    distance = max_speed.new_zeros(valid.shape[:-1])
    for i in range(n):
        det = _dot(pts[..., i, :] - out, nrm[..., i, :])
        use = (det > distance) & active[..., i]
        take = use & ok2[..., i]
        out = torch.where(take[..., None], res2[..., i, :], out)
        distance = torch.where(take, dist2[..., i],
                               torch.where(use, det, distance))
    return out


def orca_step(ped_pos, ped_vel, ped_pref, ped_radius, ped_max_speed,
              ped_valid, robot_pos, robot_vel, robot_valid,
              cfg: OrcaConfig, seg: Segments, evac_sources=None,
              evac_radii=None):
    """One crowd step: the peds' new velocities, then an Euler move.

    Peds ``[..., M]`` and robots ``[..., N]`` (their per-agent radius,
    speed and validity may omit the leading shape).  Robots join as
    neighbours (kinematic mirrors, rvoscene.h:47-66) but are not solved.
    With ``evac_sources`` [...,B,2] / ``evac_radii`` [...,B], the ERVO
    evacuation velocity is added after the LP (Agent.cpp:63-69, 429-433).
    Spans: ``orca.lines`` (the obstacle and agent ORCA lines) and
    ``orca.solve`` (the linear programs' selection chains).
    Returns (new_pos [...,M,2], new_vel [...,M,2])."""
    lead, rlead = ped_pos.shape[:-1], robot_pos.shape[:-1]
    ped_max_speed = ped_max_speed.expand(lead)
    all_pos = torch.cat([ped_pos, robot_pos], -2)
    all_vel = torch.cat([ped_vel, robot_vel], -2)
    all_radius = torch.cat([ped_radius.expand(lead),
                            ped_radius.new_full(rlead, cfg.radius)], -1)
    all_valid = torch.cat([ped_valid.expand(lead),
                           robot_valid.expand(rlead)], -1)

    with trace.span("orca.lines"):
        opt, odir, ovalid = obstacle_orca_lines(ped_pos, ped_vel,
                                                ped_max_speed, cfg, seg)
        apt, adir, avalid = agent_orca_lines(ped_pos, ped_vel, cfg, all_pos,
                                             all_vel, all_radius, all_valid)
    with trace.span("orca.solve"):
        new_vel = solve_velocities(
            torch.cat([opt, apt], -2), torch.cat([odir, adir], -2),
            torch.cat([ovalid, avalid], -1), ped_max_speed, ped_pref,
            cfg.max_obs_segments)

    if evac_sources is not None:
        evec = (ped_pos[..., :, None, :]
                - evac_sources[..., None, :, :])            # [...,M,B,2]
        en = torch.sqrt(_dot(evec, evec))
        in_range = (en <= evac_radii[..., None, :]) & (en >= 1e-4)
        new_vel = new_vel + torch.where(
            in_range[..., None], evec / en.clamp(min=1e-30)[..., None],
            0.0).sum(-2)

    v = ped_valid[..., None]
    new_vel = torch.where(v, new_vel, ped_vel)
    return torch.where(v, ped_pos + new_vel * cfg.time_step, ped_pos), new_vel


def pref_velocity(pos, goal):
    """rvoscene.h:36-44: the goal vector, normalised only if longer than 1."""
    g = goal - pos
    n_sq = (g * g).sum(-1, keepdim=True)
    return torch.where(n_sq > 1.0, g / torch.sqrt(n_sq.clamp(min=1e-30)), g)
