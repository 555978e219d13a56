"""Host-side rendering: global frame + per-robot view tiles (torch port of
``img_env_tpu.eval.render``).

Numpy re-creation of the reference GUI composite (ImgEnv::show_gui,
img_env.cpp:676-710): a colorized world map with goal lines/markers on the
left, per-robot 48x48 (or raw view) tiles on the right.  Colors are the
reference's Kelly palette (img_env.cpp:35-56).  A frame reads the few state
tensors it draws to the host once (off the step path) and is pure numpy ->
uint8 RGB; ``save_png`` writes it with the standard library (``zlib`` +
``struct``), which ``env.maps.decode_png`` reads back.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np
import torch

KELLY_COLORS = np.asarray([
    (255, 179, 0), (128, 62, 117), (255, 104, 0), (166, 189, 215),
    (193, 0, 32), (206, 162, 98), (129, 112, 102), (0, 125, 52),
    (246, 118, 142), (0, 83, 138), (255, 122, 92), (83, 55, 122),
    (255, 142, 0), (179, 40, 81), (244, 200, 0), (127, 24, 13),
    (147, 170, 0), (89, 51, 21), (241, 58, 19), (35, 44, 22),
], np.uint8)


def host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _disc(img, cy, cx, radius_px, color):
    h, w = img.shape[:2]
    y0, y1 = max(cy - radius_px, 0), min(cy + radius_px + 1, h)
    x0, x1 = max(cx - radius_px, 0), min(cx + radius_px + 1, w)
    if y0 >= y1 or x0 >= x1:
        return
    ys, xs = np.mgrid[y0:y1, x0:x1]
    m = (ys - cy) ** 2 + (xs - cx) ** 2 <= radius_px ** 2
    img[y0:y1, x0:x1][m] = color


def _line(img, p0, p1, color):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    ys = np.linspace(p0[0], p1[0], n + 1).astype(int)
    xs = np.linspace(p0[1], p1[1], n + 1).astype(int)
    ok = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
    img[ys[ok], xs[ok]] = color


def render_frame(
    state, statics, robot_radius: float = 0.17, ped_radius: float = 0.17,
    draw_goals: bool = True, beep_radius: Optional[float] = None,
) -> np.ndarray:
    """RGB frame of the world: map + obstacles (already in obs_map), peds,
    robots, goal lines, optional beep rings."""
    res = float(statics.resolution)
    occ = host(state.obs_map)
    img = np.stack([occ] * 3, axis=-1).astype(np.uint8)
    img[occ < 250] = (40, 40, 40)
    img[occ >= 250] = (255, 255, 255)

    def to_px(xy):
        # world2map: row = round(x/res), col = round(y/res) (grid_map.cpp:40-44)
        return int(round(float(xy[0]) / res)), int(round(float(xy[1]) / res))

    peds = host(state.peds.pos)
    for j in range(peds.shape[0]):
        cy, cx = to_px(peds[j])
        _disc(img, cy, cx, max(int(ped_radius / res), 2), (60, 180, 60))

    poses = host(state.robots.pose)
    goals = host(state.robots.goal)
    beeps = host(state.robots.beep)
    for i in range(poses.shape[0]):
        color = tuple(int(c) for c in KELLY_COLORS[i % len(KELLY_COLORS)])
        cy, cx = to_px(poses[i, :2])
        if draw_goals:
            gy, gx = to_px(goals[i])
            _line(img, (cy, cx), (gy, gx), (255, 0, 0))
            _disc(img, gy, gx, max(int(0.2 / res), 2), (0, 0, 255))
        _disc(img, cy, cx, max(int(robot_radius / res), 2), color)
        # heading tick
        hy = cy + int(np.cos(poses[i, 2]) * robot_radius * 2 / res)
        hx = cx + int(np.sin(poses[i, 2]) * robot_radius * 2 / res)
        _line(img, (cy, cx), (hy, hx), (0, 0, 0))
        if beep_radius and beeps[i]:
            rr = int(beep_radius / res)
            th = np.linspace(0, 2 * np.pi, 8 * rr)
            ys = (cy + rr * np.cos(th)).astype(int)
            xs = (cx + rr * np.sin(th)).astype(int)
            ok = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
            img[ys[ok], xs[ok]] = (255, 0, 255)
    return img


def render_tiles(sensor_maps, tile: int = 96, per_col: int = 5) -> np.ndarray:
    """Right-hand panel: per-robot sensor maps tiled (img_env.cpp:695-708)."""
    maps = host(sensor_maps)
    n = maps.shape[0]
    cols = (n + per_col - 1) // per_col
    out = np.full((per_col * tile, cols * tile, 3), 200, np.uint8)
    for i in range(n):
        m = maps[i]
        if m.ndim == 3:  # stacked frames -> latest
            m = m[-1]
        g = m
        if g.max() <= 1.5:
            g = g * 255.0
        # nearest-neighbor upscale
        reps = tile // g.shape[0] + 1
        g = np.repeat(np.repeat(g, reps, 0), reps, 1)[:tile, :tile]
        r, c = i % per_col, i // per_col
        out[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] = g[..., None]
    return out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def save_png(path: str, img: np.ndarray) -> None:
    """Write an 8-bit RGB [H, W, 3] (or grey [H, W]) image as a PNG: one
    unfiltered scanline per row, deflated by ``zlib``."""
    img = np.ascontiguousarray(host(img), np.uint8)
    if img.ndim == 2:
        ctype = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype = 2
    else:
        raise ValueError(f"save_png: need [H, W] or [H, W, 3], got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0,
                                            0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
