"""Sorted-layout sensor pipeline (torch port of ``img_env_tpu.ops.polar``).

View pixels are statically reordered by (FOV gate, radial band, angle) —
``PolarStatics``, a host-side numpy copy of the JAX builder held
array-equal by the tests — and the per-robot sensor stage runs flat over
robots on that layout:

  1. **Fill** (``fill_sorted``): one map read per (robot, gated slot) with
     self-exclusion by robot id — kernel K2 (csrc/fill.cu) on CUDA tensors,
     the gather twin ``fill_sorted_twin`` on CPU tensors.
  2. **Raycast** (``raycast_batched``): for each radial band c, the static
     incidence matrix B_c[p, r] carries 2^-k where pixel p is beam r's k-th
     visited sample, so ``occ[:, band] @ B_c`` sums DISTINCT powers of two
     (exact in f32 for K <= 24) and the float exponent of the count is the
     first occupied sample — the exact first hit with no per-sample gather.
  3. **Stamp + resize**: the robot's own footprint (value 100) and the
     48x48 cv2 INTER_CUBIC resize as a 16-tap gather-sum.

Without lasers (``use_laser=False``) the raycast and painter give way to
``inside_sorted`` and ``plain_values_sorted``.  A scene batch fills flat
over its S*N robots, robot i reading the map of scene i // N; a sensor
group's robots pass their in-scene ids (``rids``) for self-exclusion.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from navbench.reference.constants import (
    ANGULAR_MAP_SIZE,
    CELL_SELF_IN_VIEW,
    CELL_UNSEEN,
    CELL_VIEW_FREE,
    LASER_MISS_DIST,
)
from navbench.reference.ops import f32
from navbench.reference.ops.raster import round_half_away, div_const
from navbench.reference.ops.resize import resize_matrix
from navbench.reference.ops.view import (
    LaserStatics,
    ViewParams,
    ViewStatics,
    _pixel_base_coords,
)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class PolarStatics(NamedTuple):
    """Host-precomputed structure for the matmul sensor pipeline.

    The fields the port reads, each array-equal to the JAX builder's; the
    JAX-only shadow-decode tables (``rho_sorted``, ``beam_onehot``, [P', R]
    floats) and the Pallas fill's window diameter are not built."""

    # sorted pixel layout ----------------------------------------------------
    perm: np.ndarray            # [P] image-flat index of sorted slot p
    slot_of_pixel: np.ndarray   # [hpx*wpx] int32 inverse of perm
    n_slots: int                # P' = padded sorted length (multiple of 128)
    pix_x_sorted: np.ndarray    # [P'] base-frame pixel coords (pad -> dead)
    pix_y_sorted: np.ndarray
    gates_sorted: np.ndarray    # [P'] bool
    # raycast chunks ---------------------------------------------------------
    chunk_lo: Tuple[int, ...]   # per chunk: [lo, hi) slice of sorted slots
    chunk_hi: Tuple[int, ...]
    b_chunks: Tuple[np.ndarray, ...]  # per chunk [L_c, R] f32 2^-k weights
    refine_dist: np.ndarray     # [R, NC, K] f32 hit distance (pad 6.0)
    angular_bin: np.ndarray     # [R]
    # resize -----------------------------------------------------------------
    resize_pos: np.ndarray      # [48*48, 16] int32 sorted slots
    resize_w: np.ndarray        # [48*48, 16] f32 cubic weights
    fill_window: int            # slot alignment of the Pallas fill windows
    n_fill_slots: int           # gated prefix length the fill must cover
    params: ViewParams

    @staticmethod
    def build(p: ViewParams, sensor_base=(0.0, 0.0), image_size=(48, 48),
              n_chunks: int = None, fill_window: int = None) -> "PolarStatics":
        hpx, wpx = p.hpx, p.wpx
        P = hpx * wpx
        if fill_window is None:
            # large views amortize per-window kernel latency with big
            # windows; small views would drown in segment padding (each
            # connected arc pads to a window boundary)
            fill_window = 512 if P >= 100_000 else 128
        if n_chunks is None:
            # wider radial bands keep a fill window's arc SHORT (arc length
            # ~ window/band_width), which bounds the kernel's block size;
            # the raycast is insensitive to the chunk count (total incidence
            # work is fixed, and first-hit decode is per-chunk-exponent)
            n_chunks = 24 if P >= 100_000 else 16
        ls = LaserStatics.build(p, sensor_base)
        xb, yb = _pixel_base_coords(p)
        vs = ViewStatics.build(p, sensor_base)

        # --- radial band per pixel (distance from the sensor origin cell) ---
        ox, oy = ls.origin[0] * p.resolution, ls.origin[1] * p.resolution
        ii = np.arange(hpx)[:, None] * p.resolution
        jj = np.arange(wpx)[None, :] * p.resolution
        rho = np.hypot(ii - ox, jj - oy)
        max_range = math.hypot(p.half, p.half) + 2 * p.resolution
        band = max_range / n_chunks
        chunk_of_pixel = np.minimum((rho / band).astype(np.int64),
                                    n_chunks - 1).reshape(-1)

        # --- sorted layout, chunk slices padded to 128 -----------------------
        # Within a radial chunk, pixels are ordered by ANGLE around the
        # sensor: any 128 consecutive slots then form a short arc of a thin
        # ring, so the whole window fits a small map block whatever the
        # robot's pose (the window's diameter is rotation-invariant).  The
        # Pallas fill kernel (ops/pallas_fill.py) depends on this bound;
        # every other consumer only requires *some* consistent permutation.
        ang_of_pixel = np.arctan2(jj - oy, ii - ox).reshape(-1)
        # ALL gated (in-FOV) pixels sort before all ungated ones: consumers
        # only ever read ``occ & gates`` (raycast/shadow/plain), so the
        # Pallas fill covers just the gated PREFIX [0, n_fill_slots) —
        # roughly half the slots for a pi-FOV sensor — and the chunk slices
        # used by the raycast incidence matmuls stay contiguous.
        gated_pix = vs.gates.reshape(-1)
        gap = max(2.0 * band, 8.0 * p.resolution)
        fw = max(fill_window, 128)
        xf, yf = xb.reshape(-1), yb.reshape(-1)
        lo_list, hi_list = [], []
        slot_of_pixel = np.full(P, -1, np.int64)
        pos = 0
        # The square view clips outer rings into several disconnected arcs;
        # a fill window straddling two arcs would have a huge diameter.
        # Split each gated chunk at spatial gaps and pad every connected
        # segment to a ``fill_window``-slot boundary, so aligned windows
        # never cross a gap (a few % of dead slots, small fill blocks).
        for c in range(n_chunks):
            sel = np.nonzero((chunk_of_pixel == c) & gated_pix)[0]
            idxs = sel[np.argsort(ang_of_pixel[sel], kind="stable")]
            lc = len(idxs)
            lo_list.append(pos)
            if lc:
                d = np.hypot(np.diff(xf[idxs]), np.diff(yf[idxs]))
                breaks = np.nonzero(d > gap)[0] + 1
                bounds = [0, *breaks.tolist(), lc]
            else:
                bounds = [0, 0]
            for a, b in zip(bounds[:-1], bounds[1:]):
                seg = idxs[a:b]
                slot_of_pixel[seg] = pos + np.arange(len(seg))
                pos += _round_up(max(len(seg), 1), fw)
            hi_list.append(pos)
        n_fill_slots = pos
        # ungated pixels: beams still WRITE a few of them (Bresenham wobble
        # at the FOV edges, and the laser trace paints any traversed cell).
        # Order them so the painter's per-block beam windows stay narrow:
        # beam-VISITED ungated slots first, grouped by (chunk, FOV edge,
        # nearest beam) with each group padded to a 128-slot boundary (a
        # block then never mixes the two angular edges -> small windows);
        # never-visited slots last (one constant-200 painter region).
        ls_cells, ls_valid = ls.cells, ls.valid
        inb_u = ((ls_cells[..., 0] >= 0) & (ls_cells[..., 0] < hpx)
                 & (ls_cells[..., 1] >= 0) & (ls_cells[..., 1] < wpx))
        oob_u = ls_valid & ~inb_u
        s_dim = ls_valid.shape[1]
        first_oob_u = np.where(oob_u.any(1), oob_u.argmax(1), s_dim)
        eff_u = ls_valid & inb_u & (
            np.arange(s_dim)[None, :] < first_oob_u[:, None])
        visited_pix = np.zeros(P, bool)
        visited_pix[(ls_cells[..., 0] * wpx + ls_cells[..., 1])[eff_u]] = True

        beam_of_pixel = vs.pix_beam.reshape(-1)
        un_mask = np.logical_not(gated_pix)
        uv = np.nonzero(un_mask & visited_pix)[0]
        edge = (beam_of_pixel[uv] >= p.range_total // 2).astype(np.int64)
        uv = uv[np.lexsort((ang_of_pixel[uv], beam_of_pixel[uv], edge,
                            chunk_of_pixel[uv]))]
        group = chunk_of_pixel[uv] * 2 + (beam_of_pixel[uv]
                                          >= p.range_total // 2)
        gpos = pos
        i0 = 0
        while i0 < len(uv):
            i1 = i0
            while i1 < len(uv) and group[i1] == group[i0]:
                i1 += 1
            seg = uv[i0:i1]
            slot_of_pixel[seg] = gpos + np.arange(len(seg))
            gpos += _round_up(len(seg), 128)
            i0 = i1
        pos = gpos
        un = np.nonzero(un_mask & np.logical_not(visited_pix))[0]
        un = un[np.lexsort((ang_of_pixel[un], chunk_of_pixel[un]))]
        slot_of_pixel[un] = pos + np.arange(len(un))
        pos += len(un)
        n_slots = _round_up(pos + 1, fw)  # +1 dead slot

        perm = np.full(n_slots, -1, np.int64)
        live_pix = np.nonzero(slot_of_pixel >= 0)[0]
        perm[slot_of_pixel[live_pix]] = live_pix
        dead = perm < 0
        slot_of_pixel = np.where(slot_of_pixel < 0, n_slots - 1, slot_of_pixel)

        flat = lambda a: a.reshape(-1)
        px = np.where(dead, 1e6, flat(xb)[np.maximum(perm, 0)])
        py = np.where(dead, 1e6, flat(yb)[np.maximum(perm, 0)])
        gates = np.where(dead, False, flat(vs.gates)[np.maximum(perm, 0)])

        # --- beam-sample incidence, truncated at first out-of-map ------------
        cells, valid = ls.cells, ls.valid            # [R,S,2], [R,S]
        inb = ((cells[..., 0] >= 0) & (cells[..., 0] < hpx)
               & (cells[..., 1] >= 0) & (cells[..., 1] < wpx))
        oob = valid & ~inb
        S = cells.shape[1]
        first_oob = np.where(oob.any(1), oob.argmax(1), S)
        s_idx = np.arange(S)[None, :]
        eff = valid & inb & (s_idx < first_oob[:, None])

        pix_flat = cells[..., 0] * wpx + cells[..., 1]      # [R,S]
        pix_flat = np.where(eff, pix_flat, 0)
        sample_slot = np.where(eff, slot_of_pixel[pix_flat], -1)
        sample_chunk = np.where(
            eff, chunk_of_pixel[pix_flat], n_chunks)        # [R,S]

        R = p.range_total
        b_chunks = []
        K = 1
        for c in range(n_chunks):
            sel = sample_chunk == c
            K = max(K, int(sel.sum(1).max(initial=1)))
        refine_dist = np.full((R, n_chunks, K), LASER_MISS_DIST, np.float64)
        # Rays only ever see gated occupancy (raycast applies occ & gates,
        # mirroring the gate test in the reference's view write,
        # agent.cpp:394-401), and gated slots sort first within each chunk —
        # so the incidence matmuls cover only the (chunk-contiguous) gated
        # slices [lo_c, hi_c) — ungated samples contribute exactly zero.
        assert K <= 24, "first-hit exponent trick needs K samples in f32 mantissa"
        for c in range(n_chunks):
            lc, hc = lo_list[c], hi_list[c]
            B = np.zeros((max(hc - lc, 128), R), np.float32)
            sel = sample_chunk == c                          # [R,S]
            rs, ss = np.nonzero(sel)
            # Weighted incidence: the k-th (in walk order) sample of a beam
            # in this chunk gets weight 2^-k.  occ @ B then sums DISTINCT
            # powers of two — exact in f32 for K <= 24 — and the leading
            # bit (the float exponent) IS the first occupied sample's k, so
            # the exact first hit needs no per-sample gather.
            for r in np.unique(rs):
                s_list = ss[rs == r]                          # walk-ordered
                kk = len(s_list)
                slot_in = sample_slot[r, s_list] - lc
                keep = (slot_in >= 0) & (slot_in < B.shape[0])
                B[slot_in[keep], r] = 2.0 ** -np.arange(kk)[keep]
                refine_dist[r, c, :kk] = ls.dists[r, s_list]
            b_chunks.append(B)

        # --- sparse INTER_CUBIC resize ---------------------------------------
        oh, ow = image_size
        Wh = resize_matrix(oh, hpx)                          # [48, hpx]
        Ww = resize_matrix(ow, wpx)
        ridx = np.zeros((oh * ow, 16), np.int64)
        rw = np.zeros((oh * ow, 16), np.float64)
        hnz = [np.nonzero(Wh[a])[0] for a in range(oh)]
        wnz = [np.nonzero(Ww[b])[0] for b in range(ow)]
        for a in range(oh):
            for b in range(ow):
                o = a * ow + b
                k = 0
                for i in hnz[a]:
                    for j in wnz[b]:
                        ridx[o, k] = slot_of_pixel[i * wpx + j]
                        rw[o, k] = Wh[a, i] * Ww[b, j]
                        k += 1
                # unreferenced slots keep weight 0 on the dead slot
                ridx[o, k:] = n_slots - 1

        astep = abs(p.angle_end - p.angle_begin) / p.range_total
        ang_map_step = abs(p.angle_end - p.angle_begin) / ANGULAR_MAP_SIZE
        bins = np.clip((astep * np.arange(R) / ang_map_step).astype(np.int32),
                       0, ANGULAR_MAP_SIZE - 1)

        return PolarStatics(
            perm=perm, slot_of_pixel=slot_of_pixel.astype(np.int32),
            n_slots=n_slots,
            pix_x_sorted=px,
            pix_y_sorted=py,
            gates_sorted=gates,
            chunk_lo=tuple(lo_list), chunk_hi=tuple(hi_list),
            b_chunks=tuple(b_chunks),
            refine_dist=refine_dist,
            angular_bin=bins,
            resize_pos=ridx.astype(np.int32), resize_w=rw.astype(np.float32),
            fill_window=fw, n_fill_slots=n_fill_slots,
            params=p,
        )


def own_mask_sorted(ps: PolarStatics, own_slots, own_valid) -> np.ndarray:
    """[N, P'] bool: precompute each robot's static footprint stamp mask so
    the runtime stamp is one elementwise select instead of a scatter."""
    slots = np.asarray(own_slots)
    ok = np.asarray(own_valid)
    n = slots.shape[0]
    mask = np.zeros((n, ps.n_slots), bool)
    for i in range(n):
        mask[i, slots[i][ok[i]]] = True
    mask[:, ps.n_slots - 1] = False          # dead slot never stamps
    return mask


def own_slots_from_cells(ps: PolarStatics, own_view_cells, own_view_valid):
    """Convert per-robot static view cells to sorted slots (host-side)."""
    p = ps.params
    cells = np.asarray(own_view_cells)
    valid = np.asarray(own_view_valid)
    inb = ((cells[..., 0] >= 0) & (cells[..., 0] < p.hpx)
           & (cells[..., 1] >= 0) & (cells[..., 1] < p.wpx))
    flat = np.where(inb, cells[..., 0] * p.wpx + cells[..., 1], 0)
    slots = np.where(inb & valid, ps.slot_of_pixel[flat], ps.n_slots - 1)
    return slots.astype(np.int32), (valid & inb)


# ---------------------------------------------------------------------------
# Device tables and runtime
# ---------------------------------------------------------------------------


class PolarTables(NamedTuple):
    """The statics' arrays as tensors on the environment's device."""

    pix_x: torch.Tensor          # [P'] f32 base-frame slot coordinates
    pix_y: torch.Tensor
    gates: torch.Tensor          # [P'] bool
    b_chunks: Tuple[torch.Tensor, ...]  # per band [L_c, R] f32 2^-k
    refine_dist: torch.Tensor    # [R, NC, K] f32 hit distance (pad 6.0)
    angular_bin: torch.Tensor    # [R] int64
    resize_pos: torch.Tensor     # [48*48, 16] int64 sorted slots
    resize_w: torch.Tensor       # [48*48, 16] f32
    own_mask: torch.Tensor       # [N, P'] bool per-robot self-stamp mask


def make_tables(ps: PolarStatics, own_mask: np.ndarray,
                device) -> PolarTables:
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    f32, i64 = torch.float32, torch.int64
    return PolarTables(
        pix_x=t(ps.pix_x_sorted, f32), pix_y=t(ps.pix_y_sorted, f32),
        gates=t(ps.gates_sorted, torch.bool),
        b_chunks=tuple(t(b, f32) for b in ps.b_chunks),
        refine_dist=t(ps.refine_dist, f32),
        angular_bin=t(ps.angular_bin, i64),
        resize_pos=t(ps.resize_pos, i64), resize_w=t(ps.resize_w, f32),
        own_mask=t(own_mask, torch.bool))


def decode_packed(v, rid1):
    """Occupancy from an id-packed cell value, excluding robot ``rid1``:
    static, or >= 2 robots, or one robot whose id differs."""
    static_occ = (v & 1) > 0
    cnt = (v >> 1) & 3
    vid = (v >> 3) & 0xFFF
    return static_occ | (cnt >= 2) | ((cnt == 1) & (vid != rid1))


def _slot_cells(cos, sin, px, py, bx, by, resolution: float):
    """Cells (m, n) int64 [N, L] of slots at base-frame (bx, by) [L] under
    the poses' terms [N]: XLA's contraction of the rotation
    (raster.transform_points), the division as a product with the f32
    reciprocal, rounded half away from zero."""
    c, s = cos[:, None], sin[:, None]
    wx = f32.fma(c, bx[None], -(s * by[None])) + px[:, None]
    wy = f32.fma(s, bx[None], c * by[None]) + py[:, None]
    return (round_half_away(div_const(wx, resolution)).to(torch.int64),
            round_half_away(div_const(wy, resolution)).to(torch.int64))


def fill_sorted_twin(packed, cos, sin, px, py, pix_x, pix_y, n_fill: int,
                     resolution: float, nps: Optional[int] = None,
                     rids=None):
    """Plain-torch K2: [N, P'] bool gated-prefix occupancy.

    packed: [H, W] or [S, H, W] int32 (robot i reads scene i // nps and has
    in-scene id ``rids[i]``, by default i % nps + 1); cos/sin/px/py: [N]
    f32 pose terms; pix_x/pix_y: [P'] f32 slot coordinates, of which the
    first ``n_fill`` (the gated prefix) are filled and the rest are zero.
    """
    maps = packed if packed.dim() == 3 else packed[None]
    _, h, w = maps.shape
    n = cos.shape[0]
    nps = nps or n
    cm, cn = _slot_cells(cos, sin, px, py, pix_x[:n_fill], pix_y[:n_fill],
                         resolution)
    inside = (cm >= 0) & (cm < h) & (cn >= 0) & (cn < w)
    ridx = torch.arange(n, device=cos.device)
    if rids is None:
        rids = ridx % nps + 1
    scene = (ridx // nps)[:, None]
    v = maps[scene, cm.clamp(0, h - 1), cn.clamp(0, w - 1)]
    occ = inside & decode_packed(v, rids[:, None])
    out = torch.zeros((n, pix_x.shape[0]), dtype=torch.bool,
                      device=cos.device)
    out[:, :n_fill] = occ
    return out


def bitmap_words(w: int) -> int:
    """int32 words per map row of K2's bitmap: 32 cells a word, rows
    padded to 16 bytes."""
    return (w + 127) // 128 * 4


def occupancy_bits_twin(packed):
    """K2's pre-pass in plain torch: [S, h, bitmap_words(w)] int32 bitmap
    of the cells that are occupied for some robot (static or holding any
    robot); bit k of word q of a row is cell q * 32 + k, padding bits 0.
    ``decode_packed`` equals this bit with the cells that robot ``rid1``
    alone covers cleared: no static bit, one robot, id ``rid1``."""
    maps = packed if packed.dim() == 3 else packed[None]
    s, h, w = maps.shape
    words = bitmap_words(w)
    occ = ((maps & 1) | ((maps >> 1) & 3)) != 0
    occ = torch.nn.functional.pad(occ, (0, words * 32 - w))
    shifts = torch.arange(32, dtype=torch.int64, device=maps.device)
    bits = (occ.reshape(s, h, words, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)


def fill_sorted(ps: PolarStatics, t: PolarTables, packed, poses,
                resolution: float, rids=None):
    """[N, P'] bool GATED-prefix occupancy (self excluded), ungated suffix
    zero: K2 for CUDA tensors, its twin for CPU tensors.  Every consumer
    reads occupancy through the gates.  packed [H, W] or [S, H, W]: robot i
    of poses [N, 3] (scene-major) reads scene i // (N / S); ``rids``: its
    1-based in-scene id, int32 [N] (default i % (N / S) + 1)."""
    poses = poses.to(torch.float32)
    sin, cos = f32.sin_cos(poses[:, 2])
    px, py = poses[:, 0].contiguous(), poses[:, 1].contiguous()
    nf = int(ps.n_fill_slots)
    scenes = packed.shape[0] if packed.dim() == 3 else 1
    nps = poses.shape[0] // scenes
    return fill_sorted_twin(packed, cos, sin, px, py, t.pix_x, t.pix_y, nf,
                            resolution, nps, rids)


def inside_sorted(ps: PolarStatics, t: PolarTables, map_shape, poses,
                  resolution: float):
    """[N, P'] bool: the slot's world cell lies inside the grid map (the
    reference's FOV fill writes only where ``grid_map.is_in_map`` holds,
    agent.cpp:392-401).  The fill's coordinate arithmetic, bit for bit;
    computed over the gated prefix, the only slots its consumer reads
    through the gates, and False beyond."""
    h, w = map_shape
    poses = poses.to(torch.float32)
    sin, cos = f32.sin_cos(poses[:, 2])
    nf = int(ps.n_fill_slots)
    cm, cn = _slot_cells(cos, sin, poses[:, 0], poses[:, 1], t.pix_x[:nf],
                         t.pix_y[:nf], resolution)
    out = torch.zeros((poses.shape[0], ps.n_slots), dtype=torch.bool,
                      device=poses.device)
    out[:, :nf] = (cm >= 0) & (cm < h) & (cn >= 0) & (cn < w)
    return out


def plain_values_sorted(t: PolarTables, occ_sorted, inside):
    """use_laser=False view values, sorted order: 0 on gated occupied
    slots, the free value on gated in-map slots, the 200 background
    elsewhere (out-of-world slots keep it: the is_in_map gate wraps both
    FOV-fill writes, agent.cpp:392-401)."""
    gates = t.gates[None]
    return torch.where(
        gates & occ_sorted, 0.0,
        torch.where(gates & inside, float(CELL_VIEW_FREE),
                    float(CELL_UNSEEN))).to(torch.float32)


def raycast_batched(ps: PolarStatics, t: PolarTables, occ_sorted):
    """Exact first hit per beam for all robots.

    occ_sorted: [N, P'] bool fill occupancy.  Returns hits [N, R],
    angular [N, 72] and the raycast aux (any_hit, first_c, first_k) that
    the painter decode consumes.  The band products run as f32 matmuls
    with f32 outputs: 0/1 and 2^-k operands are exact in f32 and in TF32,
    and every count is a sum of distinct powers of two within the f32
    mantissa, so the product is exact in any summation order.
    """
    src = (occ_sorted & t.gates[None]).to(torch.float32)
    n = src.shape[0]
    nc = len(t.b_chunks)
    counts = torch.stack(
        [src[:, lo:lo + b.shape[0]] @ b
         for lo, b in zip(ps.chunk_lo, t.b_chunks)], dim=1)   # [N, NC, R]
    fired = counts > 0
    any_hit = fired.any(dim=1)
    first_c = torch.where(any_hit, fired.to(torch.uint8).argmax(dim=1),
                          torch.full_like(any_hit, nc - 1, dtype=torch.int64))
    w_first = torch.gather(counts, 1, first_c[:, None, :])[:, 0]
    e = (w_first.view(torch.int32) >> 23) & 0xFF
    first_k = torch.where(w_first > 0, 127 - e, torch.zeros_like(e))
    rd = t.refine_dist
    r, _, k = rd.shape
    flat = ((torch.arange(r, device=src.device)[None, :] * nc + first_c) * k
            + first_k.clamp(0, k - 1))
    hit_d = rd.reshape(-1)[flat]
    hits = torch.where(any_hit, hit_d, torch.full_like(hit_d, LASER_MISS_DIST))
    angular = torch.full((n, ANGULAR_MAP_SIZE), ps.params.max_dist,
                         dtype=hits.dtype, device=hits.device)
    angular = angular.scatter_reduce(
        1, t.angular_bin[None].expand(n, r), hits, "amin", include_self=True)
    return hits, angular, (any_hit, first_c, first_k)


def stamp_self_mask(values, own_mask):
    """Own footprint (value 100) over non-occupied slots
    (agent.cpp:315-322: the write skips value-0 cells)."""
    return torch.where(own_mask & (values != 0),
                       torch.full_like(values, float(CELL_SELF_IN_VIEW)),
                       values)


def sensor_maps_from_sorted(t: PolarTables, values, image_size):
    """Sparse INTER_CUBIC resize + /255 from the sorted layout: [N, 48, 48].

    The 16 taps accumulate left to right as fused multiply-adds (one
    rounding per tap), which is how XLA compiles the JAX package's
    gather-multiply-sum.  Each multiply-add runs in float64 — exact for an
    8-bit view value times a float32 weight plus a float32 sum — and rounds
    once to float32.  cv2 saturates the cubic overshoot into uint8 and
    rounds (half to even)."""
    n = values.shape[0]
    pos, w = t.resize_pos, t.resize_w.to(torch.float64)
    g = values[:, pos.reshape(-1)].reshape(n, pos.shape[0], pos.shape[1])
    g = g.to(torch.float64)
    out = (g[..., 0] * w[None, :, 0]).to(torch.float32)
    for k in range(1, pos.shape[1]):
        out = (out.to(torch.float64) + g[..., k] * w[None, :, k]).to(
            torch.float32)
    out = div_const(torch.clamp(torch.round(out), 0, 255), 255.0)
    oh, ow = image_size
    return out.reshape(n, oh, ow)
