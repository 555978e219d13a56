"""RVO2's obstacle kd-tree segment splitting: a frozen copy of the
program's ``crowd/obstacle_split.py`` (torch port of
``img_env_tpu.crowd.obstacle_split``).  Departures from the program's
code: imports point at the reference, and the program's
``orca.segments`` counter is left out.

The reference's obstacle kd-tree build (ervo_ros/src/KdTree.cpp:131-257)
splits every boundary segment that straddles the supporting line of the
partition segment chosen at each tree level, inserting collinear convex
pseudo-vertices.  Those change the ORCA constraints near adjacent or
overlapping rectangles, so the crowd step reads the split segments.

The recursion becomes a worklist of index subsets with a masked O(S^2)
classification per node, as in the JAX package: the node's optimal split
from full left/right counts (the C++ early ``break`` cannot change the
choice), then the straddling segments split at the partition line into
new slots.  It runs once per reset, so the stack lives on the host and
each node costs one host read (whether each child subset is pushed).
Capacity: ``4*O + extra`` segments; a node whose splits do not fit keeps
the surplus straddlers whole, routed to the side of their first endpoint,
and sets ``overflow``.

Masked scatters send the rejected entries of a node to one scratch slot
(``DUMP``, index S), where their writes collide in no defined order.  The
slot is dropped from the output and never read for a kept value.
"""

from __future__ import annotations

from typing import Tuple

import torch

from navbench.reference.constants import RVO_EPSILON
from navbench.reference.crowd.orca import Segments

_EPS = RVO_EPSILON


def _left_of(ax, ay, bx, by, cx, cy):
    # leftOf(a,b,c) = det(a-c, b-a)  (Definitions.h)
    return (ax - cx) * (by - ay) - (ay - cy) * (bx - ax)


def split_segments(aabb, valid, extra: int = None
                   ) -> Tuple[Segments, torch.Tensor]:
    """Post-split boundary segments of [O,4] rectangles (rvoscene.h:19-26
    vertex order, clockwise for pa < pb; O >= 1).

    Returns (Segments padded to 4*O + extra, overflowed: bool [])."""
    dev, dt = aabb.device, aabb.dtype
    o = aabb.shape[0]
    s0 = 4 * o
    if extra is None:
        extra = s0
    s = s0 + extra
    dump = s
    arange = lambda n: torch.arange(n, device=dev)

    pax, pay, pbx, pby = aabb.unbind(-1)
    v = torch.stack([torch.stack([pax, pay], -1), torch.stack([pax, pby], -1),
                     torch.stack([pbx, pby], -1), torch.stack([pbx, pay], -1)],
                    1)                                   # [O,4,2] node points
    nxt_ring = torch.roll(v, -1, 1)
    prv_ring = torch.roll(v, 1, 1)
    a_min_c = prv_ring - nxt_ring
    b_min_a = v - prv_ring
    conv0 = (a_min_c[..., 0] * b_min_a[..., 1]
             - a_min_c[..., 1] * b_min_a[..., 0]) >= 0.0

    base = 4 * arange(o)[:, None]
    off = arange(4)[None, :]
    zl = torch.zeros(extra + 1, dtype=torch.long, device=dev)
    pad2 = torch.zeros((extra + 1, 2), dtype=dt, device=dev)
    p1 = torch.cat([v.reshape(-1, 2), pad2])                # [S+1,2]
    p2 = torch.cat([nxt_ring.reshape(-1, 2), pad2])
    nxt = torch.cat([(base + (off + 1) % 4).reshape(-1), zl])
    prv = torch.cat([(base + (off + 3) % 4).reshape(-1), zl])
    zb = torch.zeros(extra + 1, dtype=torch.bool, device=dev)
    convex = torch.cat([conv0.reshape(-1), zb])
    root_ok = valid[:, None].expand(-1, 4).reshape(-1)
    alive = torch.cat([root_ok, zb])

    # root: the live original segments in order
    perm = torch.argsort(torch.where(root_ok, arange(s0), s0), stable=True)
    n_root = root_ok.sum()
    idx_a = arange(s)
    root = torch.where(idx_a < n_root,
                       torch.cat([perm, perm.new_full((extra,), -1)]), -1)
    stack = [(root, n_root)]
    n_live = torch.tensor(s0, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    not_eye = ~torch.eye(s, dtype=torch.bool, device=dev)
    it = 0
    while stack and it < 2 * s + 2:
        it += 1
        sub, n_sub = stack.pop()
        ok = idx_a < n_sub
        sid = torch.where(ok, sub, 0)                    # subset segment ids
        P1 = p1[sid]                                     # j1.point
        P2 = p2[sid]                                     # j2.point

        # optimal split: full counts (the early break is a no-op)
        jl1 = _left_of(P1[:, None, 0], P1[:, None, 1], P2[:, None, 0],
                       P2[:, None, 1], P1[None, :, 0], P1[None, :, 1])
        jl2 = _left_of(P1[:, None, 0], P1[:, None, 1], P2[:, None, 0],
                       P2[:, None, 1], P2[None, :, 0], P2[None, :, 1])
        pair_ok = ok[:, None] & ok[None, :] & not_eye
        ll = (jl1 >= -_EPS) & (jl2 >= -_EPS)
        rr = ~ll & (jl1 <= _EPS) & (jl2 <= _EPS)
        strad = ~ll & ~rr
        lcnt = (pair_ok & (ll | strad)).sum(1)
        rcnt = (pair_ok & (rr | strad)).sum(1)
        key = torch.maximum(lcnt, rcnt) * (s + 2) + torch.minimum(lcnt, rcnt)
        key = torch.where(ok, key, torch.iinfo(torch.int64).max)
        i_star = torch.argmin(key)                       # first, like C++

        # partition and splits for the chosen segment
        j1L, j2L = jl1[i_star], jl2[i_star]
        act = ok & (idx_a != i_star)
        ll_j = act & (j1L >= -_EPS) & (j2L >= -_EPS)
        rr_j = act & ~ll_j & (j1L <= _EPS) & (j2L <= _EPS)
        sp_j = act & ~ll_j & ~rr_j

        i1p, i2p = P1[i_star], P2[i_star]
        den = ((i2p[0] - i1p[0]) * (P1[:, 1] - P2[:, 1])
               - (i2p[1] - i1p[1]) * (P1[:, 0] - P2[:, 0]))
        num = ((i2p[0] - i1p[0]) * (P1[:, 1] - i1p[1])
               - (i2p[1] - i1p[1]) * (P1[:, 0] - i1p[0]))
        t = num / torch.where(den == 0, 1.0, den)
        split_pt = P1 + t[:, None] * (P2 - P1)

        n_split = sp_j.sum()
        cap_left = s - n_live
        # within capacity the splits are faithful; surplus straddlers stay
        # whole and go to the side their first endpoint favours
        rank = torch.cumsum(sp_j.long(), 0) - 1
        can = sp_j & (rank < cap_left)
        overflow = overflow | (sp_j & ~can).any()
        new_id = torch.where(can, n_live + rank, dump)
        src = torch.where(can, sid, dump)
        c2 = can[:, None]

        old_nxt = nxt[sid]
        p1[new_id] = torch.where(c2, split_pt, p1[new_id])
        p2[new_id] = torch.where(c2, P2, p2[new_id])
        nxt[new_id] = torch.where(can, old_nxt, nxt[new_id])
        prv[new_id] = torch.where(can, sid, prv[new_id])
        convex[new_id] = can | convex[new_id]
        alive[new_id] = can | alive[new_id]
        # shrink the parent: its far endpoint moves to the split point and
        # it links to the new node
        p2[src] = torch.where(c2, split_pt, p2[src])
        nxt[src] = torch.where(can, new_id, nxt[src])
        succ = torch.where(can, old_nxt, dump)
        prv[succ] = torch.where(can, new_id, prv[succ])
        n_live = n_live + torch.minimum(n_split, cap_left)

        # ordered child subsets (each j contributes <= 1 per side); the
        # kept-whole straddlers follow their j1 side only (KdTree.cpp:242)
        j1_left = j1L > 0.0
        go_l1 = ll_j | (sp_j & j1_left)
        left_el = torch.where(go_l1, sid,
                              torch.where(can & ~j1_left, new_id, -1))
        go_r1 = rr_j | (sp_j & ~j1_left)
        right_el = torch.where(go_r1, sid,
                               torch.where(can & j1_left, new_id, -1))

        children = []
        for el in (left_el, right_el):
            has = el >= 0
            pos = torch.where(has, torch.cumsum(has.long(), 0) - 1, dump)
            out = torch.full((s + 1,), -1, dtype=torch.long, device=dev)
            out[pos] = torch.where(has, el, -1)
            children.append((out[:s], has.sum()))
        push = (torch.stack([children[0][1], children[1][1]]) > 1).tolist()
        stack += [c for c, p in zip(children, push) if p]

    p1, p2 = p1[:s], p2[:s]
    nxt, prv = nxt[:s].clamp(0, s - 1), prv[:s].clamp(0, s - 1)
    convex, alive = convex[:s], alive[:s]
    d = p2 - p1
    norm = torch.sqrt((d * d).sum(-1, keepdim=True))
    dn = d / torch.where(norm == 0, 1.0, norm)
    return Segments(p1=p1, p2=p2, dir=dn, prev_dir=dn[prv], next_dir=dn[nxt],
                    convex1=convex, convex2=convex[nxt],
                    valid=alive), overflow
