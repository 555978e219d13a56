"""Occupancy composition and collision codes (torch port of
``img_env_tpu.ops.raster``).

Per step, one scene's dynamic agents become one id-packed int32 map:

  bit 0       static / ped occupied (map value < 250, or a ped stamp)
  bits 1..2   number of distinct robots covering the cell, capped at 2
  bits 3..14  robot id field: 1 + robot index wherever exactly one robot
              covers the cell (the only case any decode reads)
  bit 15      reads as ped, bit 16 reads as obstacle, bit 17 static value-2
              alias (collision categories, agent.cpp:285-327)

The robot layer goes through kernel K1 (csrc/raster.cu) on CUDA tensors;
its plain-torch twin ``robot_maps_twin`` runs for CPU tensors.  Both give
the per-cell robot count and the SUM of covering ids (the JAX CPU path
stores the max id instead; the two agree wherever count == 1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from navbench.reference.constants import CELL_FREE_MIN
from navbench.reference.ops import f32

RASTER_MAX_SPAN = 128     # csrc/raster.cu dedup window (cells per axis)


def round_half_away(x):
    """C++ ``round()`` semantics (half away from zero); torch.round is
    half-to-even."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def div_const(x, c: float):
    """``x / c`` for a Python constant ``c``, as the JAX package computes it
    under jit: XLA rewrites the division into a product with the
    reciprocal, rounded in x's dtype (1/c in float32 for float32 x).  A
    product also reads the same on CPU and CUDA tensors."""
    if x.dtype == torch.float64:
        return x * (1.0 / c)
    return x * float(np.float32(1.0) / np.float32(c))


def world_to_cell(pts, resolution: float):
    """[..., 2] world points -> [..., 2] int32 cell indices (row=x, col=y)."""
    return round_half_away(div_const(pts, resolution)).to(torch.int32)


def transform_points(pose, pts):
    """Rigid transform of base-frame points by pose [..., 3].  In float32
    the bits are those of the JAX package's CPU build: glibc's sin/cos of
    the yaw, and each row contracted by XLA into one fused multiply-add,
    ``x = fma(c, bx, -(s*by)) + px`` and ``y = fma(s, bx, c*by) + py``
    (ops/f32.py)."""
    s, c = f32.sin_cos(pose[..., 2])
    # both rows in one multiply-add over [2, ..., P]
    rows = torch.stack([c, s])[..., None]
    cross = torch.stack([-s, c])[..., None]
    xy = (f32.fma(rows, pts[..., 0], cross * pts[..., 1])
          + pose[..., :2].movedim(-1, 0)[..., None])
    return xy.movedim(0, -1).contiguous()


def _flat_idx(cells, h: int, w: int):
    """Flattened indices; out-of-map points get the sentinel h*w."""
    m, n = cells[..., 0].long(), cells[..., 1].long()
    inside = (m >= 0) & (m < h) & (n >= 0) & (n < w)
    return torch.where(inside, m * w + n, torch.full_like(m, h * w)), inside


def _scene_flat_idx(cells, valid, h: int, w: int):
    """Indices into S stacked [H, W] maps of cells [S, ..., 2] (scene s
    offset by s*h*w); invalid and out-of-map points get the sentinel
    S*h*w."""
    s = cells.shape[0]
    flat, inside = _flat_idx(cells, h, w)
    scene = torch.arange(s, device=cells.device).reshape(
        (s,) + (1,) * (flat.dim() - 1))
    return torch.where(valid & inside, flat + scene * (h * w),
                       torch.full_like(flat, s * h * w))


def scatter_occupancy(cells, valid, h: int, w: int):
    """bool [S, H, W]: cell of scene s covered by any valid point of cells
    [S, ..., 2] (valid broadcasts against cells[..., 0])."""
    s = cells.shape[0]
    flat = _scene_flat_idx(cells, valid, h, w)
    buf = torch.zeros(s * h * w + 1, dtype=torch.bool, device=cells.device)
    # index_fill_ takes the value as a scalar argument (assigning a Python
    # value copies it to the device, a host sync); the sentinel bucket is
    # dropped
    buf.index_fill_(0, flat.reshape(-1), True)
    return buf[: s * h * w].reshape(s, h, w)


def stamp_value(grid, cells, valid, value: int):
    """Write ``value`` into covered in-map cells of a uint8 grid."""
    h, w = grid.shape
    flat, inside = _flat_idx(cells, h, w)
    flat = torch.where(valid & inside, flat, torch.full_like(flat, h * w))
    out = torch.cat([grid.reshape(-1), grid.new_zeros(1)])
    out.index_fill_(0, flat.reshape(-1), value)   # bucket h*w is dropped
    return out[: h * w].reshape(h, w)


def draw_obstacles(static_map, resolution, obs_pose, obs_points, obs_mask):
    """Compose the per-episode obstacle map (img_env.cpp:169-193): value 0
    stamped into every cell an obstacle footprint point covers."""
    pts = transform_points(obs_pose, obs_points)
    return stamp_value(static_map, world_to_cell(pts, resolution), obs_mask, 0)


def check_footprint_span(robot_points, resolution: float) -> int:
    """Cells spanned by any robot's footprint under ANY rotation (from the
    points' bounding circle about the pose origin); raises past K1's
    dedup window."""
    pts = np.asarray(robot_points, np.float64)
    if pts.size == 0:
        return 0
    r = float(np.sqrt((pts ** 2).sum(-1)).max())
    span = int(np.ceil(2.0 * r / resolution)) + 2
    if span > RASTER_MAX_SPAN:
        raise ValueError(
            f"robot footprint spans up to {span} cells at resolution "
            f"{resolution}; the raster kernel takes at most "
            f"{RASTER_MAX_SPAN}")
    return span


def robot_maps_twin(cells, valid, h: int, w: int):
    """Plain-torch K1: cells [S, N, P, 2], valid [N, P] ->
    int32 [S, H, W], the sum over the robots r of scene s covering the cell
    of ((r + 1) << 12) | 1, each robot counted once per cell (r is the
    robot's index within its scene).  One scene's cells [N, P, 2] give
    [H, W]."""
    if cells.dim() == 3:
        return robot_maps_twin(cells[None], valid, h, w)[0]
    s, n = cells.shape[:2]
    flat = _scene_flat_idx(cells, valid, h, w).reshape(s * n, -1)
    srt, _ = torch.sort(flat, dim=1)
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    contrib = ((torch.arange(1, n + 1, device=cells.device) << 12) | 1
               ).repeat(s)
    weight = torch.where(first & (srt < s * h * w),
                         contrib[:, None].expand_as(srt),
                         torch.zeros_like(srt))
    buf = torch.zeros(s * h * w + 1, dtype=torch.int64, device=cells.device)
    buf.index_add_(0, srt.reshape(-1), weight.reshape(-1))
    return buf[: s * h * w].reshape(s, h, w).to(torch.int32)


def robot_maps(cells, valid, h: int, w: int):
    """(robot_count, robot_id_sum) int32 [S, H, W] from cells
    [S, N, P, 2] ([H, W] from one scene's [N, P, 2]): K1 on a CUDA tensor,
    its twin on a CPU tensor."""
    total = robot_maps_twin(cells, valid, h, w)
    return total & 0xFFF, total >> 12


class OccupancyLayers(NamedTuple):
    """Per-step composed occupancy of S scenes."""

    obs_map: torch.Tensor          # [S,H,W] uint8 static+obstacles
    ped_strong: torch.Tensor       # [S,H,W] bool right-leg stamps
    ped_weak: torch.Tensor         # [S,H,W] bool left-leg / circle-ped stamps
    robot_count: torch.Tensor      # [S,H,W] int32 distinct robots per cell
    robot_cells: torch.Tensor      # [S,N,P,2] int32 cells of robot points
    robot_cells_valid: torch.Tensor  # [N,P] bool
    packed: torch.Tensor           # [S,H,W] int32 (bit layout in the module doc)


def build_layers(obs_map, resolution, robot_pose, robot_points, robot_mask,
                 ped_pose, ped_body_points, ped_body_mask,
                 ped_left_points, ped_left_mask,
                 ped_right_points, ped_right_mask) -> OccupancyLayers:
    """Scatter all dynamic agents of S scenes into the layered occupancy.

    obs_map [S, H, W]; robot_pose [S, N, 3] and ped_pose [S, M, 3]; the
    footprint clouds [N, P, 2] / [M, L, 2] are shared by the scenes, or
    [S, M, L, 2] per scene (the gait-shifted legs); masks [N, P] / [M, L].
    Every layer is elementwise over the scenes, and all scenes' robots go
    through one K1 launch.  One scene (obs_map [H, W], poses [N, 3] and
    [M, 3]) gives layers without the scene axis."""
    if obs_map.dim() == 2:
        lay = build_layers(
            obs_map[None], resolution, robot_pose[None], robot_points,
            robot_mask, ped_pose[None], ped_body_points, ped_body_mask,
            ped_left_points, ped_left_mask, ped_right_points, ped_right_mask)
        return lay._replace(**{f: getattr(lay, f)[0] for f in lay._fields
                               if f != "robot_cells_valid"})
    _, h, w = obs_map.shape
    if robot_points.shape[0] >= 4096:
        raise ValueError(
            "packed-map robot ids use bits 3..14 (<= 4095 robots)")
    r_cells = world_to_cell(transform_points(robot_pose, robot_points),
                            resolution)
    robot_count, robot_id = robot_maps(r_cells, robot_mask, h, w)

    # the body, left-leg (weak) and right-leg (strong) points in one pass
    s, m = ped_pose.shape[:2]
    clouds = [x.expand((s,) + x.shape[-3:])
              for x in (ped_body_points, ped_left_points, ped_right_points)]
    n_weak = clouds[0].shape[2] + clouds[1].shape[2]
    p_cells = world_to_cell(transform_points(
        ped_pose, torch.cat(clouds, dim=2)), resolution)
    ped_weak = scatter_occupancy(
        p_cells[:, :, :n_weak],
        torch.cat([ped_body_mask, ped_left_mask], dim=1), h, w)
    ped_strong = scatter_occupancy(p_cells[:, :, n_weak:], ped_right_mask,
                                   h, w)

    return OccupancyLayers(
        obs_map=obs_map, ped_strong=ped_strong, ped_weak=ped_weak,
        robot_count=robot_count, robot_cells=r_cells,
        robot_cells_valid=robot_mask,
        packed=pack_layers(obs_map, ped_strong, ped_weak, robot_count,
                           robot_id))


def pack_layers(obs_map, ped_strong, ped_weak, robot_count, robot_id):
    """The id-packed int32 map (bit layout in the module doc) from the
    layers, ``robot_id`` the id-sum per cell."""
    static_occ = (obs_map < CELL_FREE_MIN) | ped_strong | ped_weak
    # the id field is only decoded where robot_count == 1; clamp the id-sum
    # of overlap cells into its 12 bits
    robot_id = torch.clamp(robot_id, max=4095)
    obs0 = obs_map == 0
    writable = ~(obs0 | (obs_map == 1) | (obs_map == 2))
    is_ped = ped_strong | (ped_weak & writable) | ((obs_map == 1) & ~obs0)
    is_obs = obs0 & ~ped_strong
    i32 = lambda b: b.to(torch.int32)
    return (i32(static_occ)
            | (torch.clamp(robot_count, max=2) << 1)
            | (robot_id << 3)
            | (i32(is_ped) << 15)
            | (i32(is_obs) << 16)
            | (i32(obs_map == 2) << 17))


def collision_codes(layers: OccupancyLayers, latched_collision,
                    latched_arrive):
    """Reference collision codes per robot (agent.cpp:285-327, 356-361):
    per footprint point the draw-priority category (1 obstacle, 2 ped,
    3 other robot), the LAST nonzero point wins; latched robots keep
    theirs (``Agent::view`` early-returns, agent.cpp:358).  Layers of S
    scenes and latched [S, N] give codes [S, N] int32; one scene's, [N]."""
    if layers.packed.dim() == 2:
        one = layers._replace(packed=layers.packed[None],
                              robot_cells=layers.robot_cells[None])
        return collision_codes(one, latched_collision[None],
                               latched_arrive[None])[0]
    cells, valid = layers.robot_cells, layers.robot_cells_valid
    _, h, w = layers.packed.shape
    s = cells.shape[0]
    m, n = cells[..., 0].long(), cells[..., 1].long()
    inside = (m >= 0) & (m < h) & (n >= 0) & (n < w)
    scene = torch.arange(s, device=cells.device)[:, None, None]
    flat = (scene * h + m.clamp(0, h - 1)) * w + n.clamp(0, w - 1)
    v = layers.packed.reshape(-1)[flat]
    v = torch.where(inside, v, torch.zeros_like(v))
    ped_hit = (v >> 15) & 1
    obs_hit = (v >> 16) & 1
    other_robot = (((v >> 1) & 3) > 1) | (((v >> 17) & 1) > 0)
    code = torch.where(obs_hit > 0, 1, torch.where(
        ped_hit > 0, 2, torch.where(other_robot, 3, 0)))
    code = torch.where(valid & inside, code, torch.zeros_like(code))
    p = code.shape[-1]
    # last nonzero point: the largest index with code != 0
    idx = torch.arange(p, device=code.device).expand_as(code)
    last = torch.where(code != 0, idx, torch.full_like(idx, -1)).amax(dim=-1)
    fresh = torch.where(
        last >= 0,
        torch.gather(code, -1, last.clamp(min=0)[..., None])[..., 0],
        torch.zeros_like(last)).to(torch.int32)
    keep = (latched_collision > 0) | latched_arrive
    return torch.where(keep, latched_collision.to(torch.int32), fresh)
