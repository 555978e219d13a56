"""Exact laser-mode view-map decode ("painter"), torch port of
``img_env_tpu.ops.painter`` with kernel K3 (csrc/paint.cu).

The reference's laser trace (agent.cpp:356-509, 511-624) deep-copies the
view map right after ``empty_map()`` — BEFORE the FOV fill — so the final
laser-mode view map is an all-200 canvas painted only by the per-beam
Bresenham walks, in beam order (the last writer wins):

  * pre-hit samples write 255,
  * the first occupied sample writes 0 (the hit),
  * post-hit samples sharing the hit's minor coordinate write nothing,
  * later samples write 200.

A beam's write at static step s depends on two per-beam scalars, ``s_hit``
and ``s_tail`` (``hit_steps``), and which beams visit which slot is static
geometry — so the decode is integer compare/max work over static tables.

``PainterStatics`` is a host-side numpy copy of the JAX package's builder
(painter.py), held array-equal by the tests; its block layout was chosen
for the TPU and is kept as is.  ``PaintSlots`` lists each slot's visiting
beams in descending order, the layout kernel K3 walks (one launch,
slot-order tiles, the first writing beam decides).
``PaintBlocks`` flattens the gen-1 layout (``paint_mode='block'``) into the
64-slot blocks and beam windows kernel K5 (csrc/paint_block.cu) walks.
``paint_sorted`` — the dense decode over regions — is the plain-torch twin
of both.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from navbench.reference.constants import CELL_UNSEEN, CELL_VIEW_FREE
from navbench.reference.ops.polar import PolarStatics
from navbench.reference.ops.view import LaserStatics, beam_walk_tables

_BIG = np.int32(2 ** 14)       # "no hit" sentinel step (any real s < this)
NARROW_W = 128                 # K5 walks windows up to this wide 64 robots
                               # a block, wider ones 4 robots a block
_BM = 64                       # slots per painter block: windows cover half
                               # the angular drift of 128-slot blocks; the
                               # Pallas kernel packs two neighbouring blocks
                               # side by side to keep full 128-lane compute,
                               # so width CLASSES are shared per block PAIR


class PainterRegion(NamedTuple):
    lo: int                 # first slot covered
    nb: int                 # number of BM-slot blocks
    W: int                  # beam-window width (0 -> constant-200 region)
    rbase: np.ndarray       # [nb] int32 window start beam per block
    widx: np.ndarray        # [nb, W] int32 clipped beam index per window pos
    sstep: np.ndarray       # [nb, W, BM] int16: step+1 of the visit, 0=none
                            #   (BM minor so slots ride the VPU lanes)


class PainterStatics(NamedTuple):
    regions: Tuple[PainterRegion, ...]
    globstep: np.ndarray    # [R, NC, K] int16 global step of chunk sample k
    nxt_flat: np.ndarray    # [R*S] int16 minor-run end lookup
    n_steps: int            # S
    n_slots: int            # painted slot count (= P')
    # near-sensor slots are visited by beams spanning most of the range —
    # a dense per-slot row over ALL beams wastes far less than a 1024-wide
    # block window (their true incidence is dense anyway)
    wide_slots: np.ndarray = None   # [ns] int32 slot ids (painted space)
    wide_sstep: np.ndarray = None   # [ns, R] int16 step+1, 0 = none

    @staticmethod
    def build(ps: PolarStatics, sensor_base=(0.0, 0.0)) -> "PainterStatics":
        p = ps.params
        ls = LaserStatics.build(p, sensor_base)
        cells = ls.cells
        R, S = ls.valid.shape
        eff, nxt = beam_walk_tables(ls, p)

        # ---- global step of each (beam, chunk, k) raycast sample ----------
        # mirrors the b_chunks walk-order grouping in PolarStatics.build
        ox, oy = ls.origin[0] * p.resolution, ls.origin[1] * p.resolution
        ii = np.arange(p.hpx)[:, None] * p.resolution
        jj = np.arange(p.wpx)[None, :] * p.resolution
        rho = np.hypot(ii - ox, jj - oy)
        nc = len(ps.b_chunks)
        band = (math.hypot(p.half, p.half) + 2 * p.resolution) / nc
        chunk_of_pixel = np.minimum((rho.reshape(-1) / band).astype(np.int64),
                                    nc - 1)
        pix_flat = cells[..., 0] * p.wpx + cells[..., 1]
        pix_flat = np.where(eff, pix_flat, 0)
        sample_chunk = np.where(eff, chunk_of_pixel[pix_flat], nc)
        K = ps.refine_dist.shape[-1]
        globstep = np.full((R, nc, K), _BIG, np.int32)
        for c in range(nc):
            sel = sample_chunk == c
            rs, ss = np.nonzero(sel)
            for r in np.unique(rs):
                s_list = ss[rs == r]
                globstep[r, c, : len(s_list)] = s_list

        # ---- per-slot visitor lists -> blocked window tables --------------
        slot_of_pixel = ps.slot_of_pixel
        ent_r, ent_s = np.nonzero(eff)
        ent_slot = slot_of_pixel[
            cells[ent_r, ent_s, 0] * p.wpx + cells[ent_r, ent_s, 1]]
        P = ps.n_slots
        nb_total = P // _BM
        assert nb_total * _BM == P, "sorted layout must be 128-aligned"

        # ---- wide (near-sensor) slots: dense per-slot rows over all beams
        smin = np.full(P, np.iinfo(np.int32).max, np.int64)
        smax = np.full(P, -1, np.int64)
        np.minimum.at(smin, ent_slot, ent_r)
        np.maximum.at(smax, ent_slot, ent_r)
        span = np.where(smax >= 0, smax - np.minimum(smin, smax) + 1, 0)
        wide = span > 256
        wide_slots = np.nonzero(wide)[0].astype(np.int32)
        wid_of_slot = np.full(P, -1, np.int64)
        wid_of_slot[wide_slots] = np.arange(len(wide_slots))
        wide_sstep = np.zeros((max(len(wide_slots), 1), R), np.int16)
        is_wide_ent = wide[ent_slot]
        wide_sstep[wid_of_slot[ent_slot[is_wide_ent]],
                   ent_r[is_wide_ent]] = (ent_s[is_wide_ent] + 1).astype(
                       np.int16)
        keep = np.logical_not(is_wide_ent)
        ent_r, ent_s, ent_slot = ent_r[keep], ent_s[keep], ent_slot[keep]

        ent_blk = ent_slot // _BM
        # per-block beam range
        bmin = np.full(nb_total, np.iinfo(np.int32).max, np.int64)
        bmax = np.full(nb_total, -1, np.int64)
        np.minimum.at(bmin, ent_blk, ent_r)
        np.maximum.at(bmax, ent_blk, ent_r)
        wblk = np.where(bmax >= 0, bmax - np.minimum(bmin, bmax) + 1, 0)

        # Window start per block: aligned DOWN to 8 (the Pallas kernel
        # slices the int32 threshold rows at rbase — int32 sublane tiling
        # allows multiples of 8); width class covers [rbase8, bmax] rounded
        # up to a multiple of 8 (the table block's W equals its array dim,
        # so Mosaic accepts any W).
        r_pad = (R + 127) // 128 * 128
        rb16 = np.maximum(np.minimum(bmin, bmax), 0) // 8 * 8
        w_need = np.where(bmax >= 0, bmax - rb16 + 1, 0)
        wcls = np.zeros(nb_total, np.int64)
        nzb = wblk > 0
        fine = (w_need + 15) // 16 * 16
        coarse = np.maximum(
            2 ** np.ceil(np.log2(np.maximum(w_need, 1))).astype(int), 128)
        wcls[nzb] = np.where(w_need[nzb] <= 128, fine[nzb], coarse[nzb])
        wcls = np.minimum(wcls, r_pad)
        # width class shared per block PAIR (the kernel computes two
        # neighbouring 64-slot blocks side by side in one 128-lane pass)
        wpair = np.maximum(wcls[0::2], wcls[1::2])
        wcls = np.repeat(wpair, 2)
        rb16 = np.minimum(rb16, np.maximum(r_pad - wcls, 0))
        # fold short zero-runs into the wider neighbour class so regions
        # stay few; long zero runs become free constant-200 regions
        cls = wcls.copy()
        i = 0
        while i < nb_total:
            j = i
            while j < nb_total and cls[j] == cls[i]:
                j += 1
            if cls[i] == 0 and (j - i) < 4 and (i > 0 or j < nb_total):
                left = cls[i - 1] if i > 0 else 0
                right = cls[j] if j < nb_total else 0
                cls[i:j] = max(left, right)
            i = j
        # merge micro-regions (< 4 blocks) into the wider neighbour class to
        # bound the number of XLA ops without inflating entries much
        i = 0
        while i < nb_total:
            j = i
            while j < nb_total and cls[j] == cls[i]:
                j += 1
            if 0 < cls[i] and (j - i) < 4:
                left = cls[i - 1] if i > 0 else 0
                right = cls[j] if j < nb_total else 0
                m = max(left, right)
                if m > cls[i]:
                    cls[i:j] = m
            i = j

        # entries grouped by block for table fill
        order = np.argsort(ent_blk, kind="stable")
        ent_blk_o = ent_blk[order]
        ent_r_o = ent_r[order]
        ent_s_o = ent_s[order]
        ent_slot_o = ent_slot[order]
        blk_start = np.searchsorted(ent_blk_o, np.arange(nb_total))
        blk_end = np.searchsorted(ent_blk_o, np.arange(nb_total) + 1)

        regions = []
        i = 0
        while i < nb_total:
            j = i
            while j < nb_total and cls[j] == cls[i]:
                j += 1
            W = int(cls[i])
            nb = j - i
            if W == 0:
                regions.append(PainterRegion(
                    lo=i * _BM, nb=nb, W=0,
                    rbase=np.zeros(nb, np.int32),
                    widx=np.zeros((nb, 0), np.int32),
                    sstep=np.zeros((nb, _BM, 0), np.int16)))
                i = j
                continue
            rbase = np.zeros(nb, np.int32)
            sstep = np.zeros((nb, W, _BM), np.int16)
            for b in range(i, j):
                lo_e, hi_e = blk_start[b], blk_end[b]
                if hi_e <= lo_e:
                    continue
                rb = int(rb16[b])
                rbase[b - i] = rb
                rr = ent_r_o[lo_e:hi_e] - rb
                mm = ent_slot_o[lo_e:hi_e] - b * _BM
                assert (rr >= 0).all() and (rr < W).all(), (rb, W)
                sstep[b - i, rr, mm] = (ent_s_o[lo_e:hi_e] + 1).astype(np.int16)
            widx = np.clip(rbase[:, None] + np.arange(W)[None, :], 0, R - 1)
            regions.append(PainterRegion(
                lo=i * _BM, nb=nb, W=W, rbase=rbase,
                widx=widx.astype(np.int32), sstep=sstep))
            i = j

        nxt_flat = np.minimum(nxt, _BIG).astype(np.int16).reshape(-1)
        return PainterStatics(
            regions=tuple(regions),
            globstep=np.minimum(globstep, _BIG).astype(np.int16),
            nxt_flat=nxt_flat, n_steps=S, n_slots=P,
            wide_slots=wide_slots, wide_sstep=wide_sstep,
        )


class PaintSlots(NamedTuple):
    """K3's layout: per painted slot, in slot order, the beams that visit
    it in descending beam order, each as ``(beam << 16) | T`` with T the
    visit's step+1 (CSR: slot j's visits are ``visits[off[j]:off[j+1]]``).
    The visits are exactly the twin's: the regions' tables and the wide
    rows.  Every slot of the painted space is one CSR entry, and no visit
    lies past the last beam."""

    off: np.ndarray         # [n_slots + 1] int32 offsets into visits
    visits: np.ndarray      # [nv] int32 (beam << 16) | (step + 1)

    @staticmethod
    def build(pst: PainterStatics) -> "PaintSlots":
        n_beams = pst.globstep.shape[0]
        slot, beam, step = [], [], []
        for reg in pst.regions:
            b, w, m = np.nonzero(reg.sstep)
            slot.append(reg.lo + b * _BM + m)
            beam.append(reg.rbase[b].astype(np.int64) + w)
            step.append(reg.sstep[b, w, m])
        ns = len(pst.wide_slots)
        i, r = np.nonzero(pst.wide_sstep[:ns])
        slot.append(pst.wide_slots[i])
        beam.append(r)
        step.append(pst.wide_sstep[i, r])
        slot, beam, step = (np.concatenate(x).astype(np.int64)
                            for x in (slot, beam, step))
        if (beam >= n_beams).any():
            raise ValueError("a painter visit lies past the last beam")
        order = np.lexsort((-beam, slot))
        counts = np.bincount(slot, minlength=pst.n_slots)
        return PaintSlots(
            off=np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
            visits=((beam[order] << 16) | step[order]).astype(np.int32))


class PaintBlocks(NamedTuple):
    """K5's blocks: the gen-1 layout's 64-slot blocks, each with one beam
    window [rb, rb + w) (beams past R - 1 clip to it, and visit nothing)
    and a [w, BM] int16 table of visit step+1 (0 = not visited).  The
    regions' blocks (their wide slots masked out, constant-200 regions as
    w = 0) and packs of BM wide slots over all beams, listed widest window
    first (the kernel starts the long blocks first): every slot of the
    painted space is in exactly one block."""

    slots: np.ndarray       # [nb, BM] int32 slot id (-1 = none)
    rb: np.ndarray          # [nb] int32 window start beam
    w: np.ndarray           # [nb] int32 window width
    off: np.ndarray         # [nb] int64 table offset, in BM-entry rows
    table: np.ndarray       # [sum(w), BM] int16
    cap: int                # the most visits any one block holds
    n_wide: int             # leading blocks whose window is wider than
                            # NARROW_W (the kernel walks fewer robots a block)

    @staticmethod
    def build(pst: PainterStatics, n_beams: int) -> "PaintBlocks":
        if n_beams >= 2 ** 15:      # the kernel packs (position << 16) | T
            raise ValueError("the block painter takes fewer than 32768 beams")
        wide_ids = np.asarray(pst.wide_slots, np.int32)
        wide = np.zeros(pst.n_slots, bool)
        wide[wide_ids] = True
        slots, rbs, ws, tabs = [], [], [], []
        for reg in pst.regions:
            for b in range(reg.nb):
                ids = reg.lo + b * _BM + np.arange(_BM, dtype=np.int32)
                slots.append(np.where(wide[ids], -1, ids))
                rbs.append(int(reg.rbase[b]) if reg.W else 0)
                ws.append(reg.W)
                tabs.append(reg.sstep[b] if reg.W
                            else np.zeros((0, _BM), np.int16))
        rows = np.asarray(pst.wide_sstep, np.int16)[:len(wide_ids)]
        for a in range(0, len(wide_ids), _BM):
            k = len(wide_ids[a:a + _BM])
            ids = np.full(_BM, -1, np.int32)
            ids[:k] = wide_ids[a:a + _BM]
            t = np.zeros((n_beams, _BM), np.int16)
            t[:, :k] = rows[a:a + _BM].T
            slots.append(ids)
            rbs.append(0)
            ws.append(n_beams)
            tabs.append(t)
        order = np.argsort(-np.asarray(ws), kind="stable")
        w = np.asarray(ws, np.int32)[order]
        off = np.concatenate([[0], np.cumsum(w)[:-1]]).astype(np.int64)
        tabs = [tabs[i] for i in order]
        return PaintBlocks(slots=np.stack(slots)[order].astype(np.int32),
                           rb=np.asarray(rbs, np.int32)[order], w=w, off=off,
                           table=np.ascontiguousarray(
                               np.concatenate(tabs, axis=0).astype(np.int16)),
                           cap=max(int((t != 0).sum()) for t in tabs),
                           n_wide=int((w > NARROW_W).sum()))


class PainterTables(NamedTuple):
    """Painter statics as tensors on the environment's device."""

    globstep: torch.Tensor                 # [R, NC, K] int64
    nxt: torch.Tensor                      # [R, S] int64
    region_widx: Tuple[torch.Tensor, ...]  # per region [nb, W] int64
    region_sstep: Tuple[torch.Tensor, ...]  # per region [nb, W, BM] int16
    wide_slots: torch.Tensor               # [ns] int64
    wide_sstep: torch.Tensor               # [ns, R] int16
    slots: Optional[Tuple[torch.Tensor, ...]]    # K3's PaintSlots fields
    blocks: Optional[Tuple[torch.Tensor, ...]]   # K5's PaintBlocks arrays
    # K5's launch sizes: (n_wide, widest window, widest other window, cap)
    block_sizes: Tuple[int, ...] = ()


def make_painter_tables(pst: PainterStatics, layout, device) -> PainterTables:
    """``layout``: PaintSlots (kernel K3) or PaintBlocks (kernel K5); the
    other kernel's field is None."""
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                      device=device)
    i64, i32, i16 = torch.int64, torch.int32, torch.int16
    r = pst.globstep.shape[0]
    blocks = isinstance(layout, PaintBlocks)
    if blocks:
        launch = (t(layout.slots, i32), t(layout.rb, i32), t(layout.w, i32),
                  t(layout.off, i64), t(layout.table, i16))
    else:
        launch = (t(layout.off, i32), t(layout.visits, i32))
    return PainterTables(
        globstep=t(pst.globstep, i64),
        nxt=t(pst.nxt_flat.reshape(r, pst.n_steps), i64),
        region_widx=tuple(t(g.widx, i64) for g in pst.regions),
        region_sstep=tuple(t(g.sstep, i16) for g in pst.regions),
        wide_slots=t(pst.wide_slots, i64),
        wide_sstep=t(pst.wide_sstep, i16),
        slots=None if blocks else launch,
        blocks=launch if blocks else None,
        block_sizes=((layout.n_wide, int(layout.w.max(initial=0)),
                      int(layout.w[layout.n_wide:].max(initial=0)),
                      layout.cap) if blocks else ()))


def hit_steps(pst: PainterStatics, t: PainterTables, any_hit, first_c,
              first_k):
    """Per-beam (s_hit, s_tail) int16 [N, R] from the raycast decode:
    s_hit = the first hit's global walk step (globstep[r, c, 0] + k, since
    a chunk's samples are consecutive steps), s_tail = the minor-run end
    after it; no hit -> the 2**14 sentinel for both."""
    r, nc, k = pst.globstep.shape
    n = any_hit.shape[0]
    base = t.globstep[:, :, 0]                                  # [R, NC]
    hit_base = torch.gather(base[None].expand(n, r, nc), 2,
                            first_c[..., None])[..., 0]
    s_hit = torch.where(any_hit, hit_base + first_k.clamp(0, k - 1),
                        torch.full_like(hit_base, int(_BIG)))
    s_clip = s_hit.clamp(0, pst.n_steps - 1)
    tail = torch.gather(t.nxt[None].expand(n, r, pst.n_steps), 2,
                        s_clip[..., None])[..., 0]
    s_tail = torch.where(any_hit, tail, torch.full_like(tail, int(_BIG)))
    return s_hit.to(torch.int16), s_tail.to(torch.int16)


def _decode(win):
    c = win & 3
    return torch.where(
        win < 0, float(CELL_UNSEEN),
        torch.where(c == 2, float(CELL_VIEW_FREE),
                    torch.where(c == 3, 0.0, float(CELL_UNSEEN)))
    ).to(torch.float32)


def _codes(T, sh, st):
    """Painter code per visit: 2 pre-hit, 3 hit, 1 post-run, 0 none."""
    return torch.where(
        T <= sh, 2, torch.where(T == sh + 1, 3, torch.where(T > st, 1, 0)))


def paint_sorted(pst: PainterStatics, t: PainterTables, s_hit, s_tail,
                 robot_chunk: int = 8):
    """K3's plain-torch twin: exact view values [N, P'] f32 in
    {0, 200, 255} by the dense decode over regions, ``robot_chunk``
    robots at a time (its [n, nb, W, BM] intermediate is large)."""
    outs = [_paint_regions(pst, t, s_hit[a:a + robot_chunk],
                           s_tail[a:a + robot_chunk])
            for a in range(0, s_hit.shape[0], robot_chunk)]
    return (torch.cat(outs, 0) if outs else
            torch.zeros((0, pst.n_slots), dtype=torch.float32,
                        device=s_hit.device))


def _paint_regions(pst, t, s_hit, s_tail):
    n = s_hit.shape[0]
    sh16, st16 = s_hit.to(torch.int16), s_tail.to(torch.int16)
    outs = []
    for ridx, reg in enumerate(pst.regions):
        if reg.W == 0:
            outs.append(torch.full((n, reg.nb * _BM), float(CELL_UNSEEN),
                                   dtype=torch.float32, device=s_hit.device))
            continue
        widx = t.region_widx[ridx].reshape(-1)
        sh = sh16[:, widx].reshape(n, reg.nb, reg.W, 1)
        st = st16[:, widx].reshape(n, reg.nb, reg.W, 1)
        T = t.region_sstep[ridx][None]                      # [1, nb, W, BM]
        code = _codes(T, sh, st).to(torch.int16)
        w_pos = torch.arange(reg.W, dtype=torch.int16,
                             device=s_hit.device)[None, None, :, None]
        key = torch.where((T > 0) & (code > 0), (w_pos << 2) | code,
                          torch.full_like(code, -1))
        outs.append(_decode(key.amax(dim=2)).reshape(n, reg.nb * _BM))
    vals = torch.cat(outs, dim=1)[:, : pst.n_slots]
    if pst.wide_slots is not None and pst.wide_slots.size:
        T = t.wide_sstep[None]                              # [1, ns, R]
        code = _codes(T, sh16[:, None, :], st16[:, None, :]).to(torch.int16)
        beam = torch.arange(T.shape[2], dtype=torch.int16,
                            device=s_hit.device)[None, None, :]
        key = torch.where((T > 0) & (code > 0), (beam << 2) | code,
                          torch.full_like(code, -1))
        vals[:, t.wide_slots] = _decode(key.amax(dim=-1))
    return vals


def _check_thresholds(t: PainterTables, s_hit, s_tail, launch):
    if (s_hit.shape != s_tail.shape or s_hit.dim() != 2
            or s_hit.shape[1] != t.globstep.shape[0]):
        raise ValueError("paint kernel takes s_hit/s_tail [N, R] with the "
                         "tables' R beams")
    if launch is None:
        raise ValueError("painter tables hold the other kernel's layout")


def paint(pst: PainterStatics, t: PainterTables, s_hit, s_tail):
    """Exact view values [N, P'] f32: for CUDA tensors K5 when the tables
    hold PaintBlocks (``paint_mode='block'``), K3 otherwise; the twin for
    CPU tensors."""
    return paint_sorted(pst, t, s_hit, s_tail)
