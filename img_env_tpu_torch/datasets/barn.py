"""BARN-style world generation (occupancy-map benchmark worlds; port of
``img_env_tpu.datasets.barn``, host numpy).

The reference's BarnDataSetWrapper (evaluation_wrapper/BarnDataSetWrapper.py:
14-110) drives Gazebo over the 300-world BARN dataset (Perille et al. 2020).
Those worlds are 30x30 cylinder grids generated by a cellular automaton and
filtered for start-goal connectivity.  This module generates statistically
equivalent worlds directly as occupancy-grid PNGs that `eval/barn.py` can
benchmark without Gazebo: random seed fill -> CA smoothing (a cell is an
obstacle when >=5 of its 8 neighbours are) -> flood-fill connectivity check
between the bottom and top clear bands, retrying the seed until connected.
A seed gives the JAX package's world: both draw from numpy's
``default_rng(seed * 1000 + try)``.

PNGs are written and read with the standard library (``zlib``, ``struct``;
no OpenCV or PIL): grey, 8 bits, which ``env/maps.decode_png`` reads.

To run against the REAL BARN set instead, convert its `.world` files once
(``convert_barn_worlds``): each cylinder at (x, y) marks an obstacle cell at
the same 0.15 m pitch — `grid[round(x/0.15), round(y/0.15)] = 0`.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from typing import List, Tuple

import numpy as np

from img_env_tpu_torch.env.maps import decode_png

CELL_M = 0.15                 # BARN cylinder pitch
FREE, OBST = 255, 0


def _ca_smooth(occ: np.ndarray, iters: int) -> np.ndarray:
    """Cellular-automaton smoothing over the 8-neighbourhood (cave rule:
    a cell is born with >=5 occupied neighbours, survives with >=4 — the
    plain nb>=5 rule starves the map to ~5% density; this one holds the
    BARN-like ~25% obstacle density at fill 0.4)."""
    for _ in range(iters):
        p = np.pad(occ, 1, constant_values=True)
        nb = sum(
            p[1 + dr: 1 + dr + occ.shape[0], 1 + dc: 1 + dc + occ.shape[1]]
            for dr in (-1, 0, 1) for dc in (-1, 0, 1)
            if (dr, dc) != (0, 0)
        )
        occ = (nb >= 5) | (occ & (nb >= 4))
    return occ


def _connected(occ: np.ndarray, band: int, inflate: int = 1) -> bool:
    """Flood fill from the bottom clear band; reachable top band => True.

    ``inflate`` erodes the free space first (a cell is traversable only if
    its ``inflate``-neighbourhood is free): cell-level connectivity admits
    0.15 m corridors no physical robot fits through — the real BARN set is
    filtered for *navigability* of a Jackal, not raw connectivity."""
    if inflate > 0:
        free = ~occ
        for _ in range(inflate):
            p = np.pad(free, 1, constant_values=False)
            # 8-neighbourhood erosion: 4-neighbour erosion admits diagonal
            # chokepoints no physical footprint threads
            free = np.ones_like(free)
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    free &= p[1 + dr:1 + dr + occ.shape[0],
                              1 + dc:1 + dc + occ.shape[1]]
        occ = ~free
        occ[:band, :] = False           # clear bands stay traversable
        occ[-band:, :] = False
    rows, cols = occ.shape
    seen = np.zeros_like(occ, bool)
    stack: List[Tuple[int, int]] = [
        (r, c) for r in range(band) for c in range(cols) if not occ[r, c]
    ]
    for r, c in stack:
        seen[r, c] = True
    while stack:
        r, c = stack.pop()
        if r >= rows - band:
            return True
        for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            rr, cc = r + dr, c + dc
            if 0 <= rr < rows and 0 <= cc < cols and not occ[rr, cc] \
                    and not seen[rr, cc]:
                seen[rr, cc] = True
                stack.append((rr, cc))
    return False


def generate_barn_world(
    seed: int,
    rows: int = 30,
    cols: int = 30,
    fill: float = 0.4,
    smooth_iters: int = 2,
    clear_band: int = 4,
    max_tries: int = 50,
) -> np.ndarray:
    """Boolean obstacle grid [rows, cols]; bottom/top ``clear_band`` rows are
    kept free (start/goal regions) and bottom-to-top connectivity holds."""
    for t in range(max_tries):
        rng = np.random.default_rng(seed * 1000 + t)
        occ = rng.random((rows, cols)) < fill
        occ = _ca_smooth(occ, smooth_iters)
        occ[:clear_band, :] = False
        occ[-clear_band:, :] = False
        # inflate=2: require a 5-cell-wide (0.6 m after the loader's
        # bilinear obstacle fattening, env/maps.py) navigable channel —
        # a 0.17 m robot physically threads it with clearance to spare
        if _connected(occ, clear_band, inflate=2):
            return occ
    raise RuntimeError(f"no connected world for seed {seed}")


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_grey_png(path: str, img: np.ndarray) -> None:
    """uint8 [H, W] -> an 8-bit grey PNG (filter 0 on every row)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], 1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0,
                                                  0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw, 9))
                + _png_chunk(b"IEND", b""))


def save_world_png(path: str, occ: np.ndarray) -> None:
    """Occupancy grid -> grayscale PNG (obstacle 0, free 255) with a 1-cell
    border wall, matching the repo's map value convention (free >= 250)."""
    img = np.where(occ, OBST, FREE).astype(np.uint8)
    write_grey_png(path, np.pad(img, 1, constant_values=OBST))


def generate_worlds(out_dir: str, n: int = 3, seed0: int = 0,
                    **kw) -> List[str]:
    """Generate ``n`` worlds as ``barn_world_{i}.png`` under ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(n):
        occ = generate_barn_world(seed0 + i, **kw)
        p = os.path.join(out_dir, f"barn_world_{i}.png")
        save_world_png(p, occ)
        paths.append(p)
    return paths


def world_cfg_dict(world_png: str, n_beams: int = 90) -> dict:
    """EnvConfig dict for one BARN world: single robot crossing bottom->top
    (the reference's Jackal task), map at the BARN 0.15 m pitch."""
    h_cells, w_cells = decode_png(world_png).shape[:2]
    x_max = h_cells * CELL_M
    y_max = w_cells * CELL_M
    # start/goal 0.6 m off the border wall, in the last guaranteed-free
    # band cell (ADVICE.md: with the 1-cell border the robot's clearance
    # sits at the 0.45 m default safety band; run_barn's corridor profile
    # narrows it to 0.25 m)
    edge = 4 * CELL_M
    return {
        "env_name": "barn",
        "control_hz": 0.4,
        "robot": {
            "total": 1,
            "shape": ["circle"],
            "size": [[0.0, 0.0, 0.17]],
            "begin_poses_type": ["fix"],
            "begin_poses": [[edge, y_max / 2, 1.57]],
            "target_poses_type": ["fix"],
            "target_poses": [[x_max - edge, y_max / 2]],
        },
        "object": {"total": 0},
        "ped_sim": {"total": 0, "type": ""},
        "global_map": {
            "map_file": os.path.basename(world_png),
            "resolution": CELL_M,
        },
        "map_dir": os.path.dirname(os.path.abspath(world_png)),
        "view_map": {"resolution": 0.05, "width": 3.0, "height": 3.0},
        "range_total": n_beams,
        "max_ped": 1,
        "state_dim": 3,
        "wrapper": [
            "VelActionWrapper", "TimeLimitWrapper",
            "SensorsPaperRewardWrapper", "InfoLogWrapper",
            "StateBatchWrapper", "NeverStopWrapper",
        ],
        "time_max": 100,
        "continuous_actions": [[0.0, 0.6], [-0.9, 0.9]],
    }


def convert_barn_world(path: str,
                       cell_m: float = CELL_M,
                       pad_cells: int = 2) -> np.ndarray:
    """Real BARN ``.world`` (Gazebo SDF) -> occupancy grid (FREE/OBST).

    BARN worlds place one ``unit_cylinder`` model per obstacle cell at the
    0.15 m pitch; each ``<model name='unit_cylinder_N'>`` block carries a
    ``<pose>x y z r p y</pose>``.  The converter reads those poses with a
    dependency-free scan and marks ``grid[round(x/0.15), round(y/0.15)]``,
    normalizing the origin so the smallest cylinder lands at
    ``pad_cells``.  Feed the result to ``save_world_png`` for eval/barn.py.
    """
    with open(path) as f:
        text = f.read()
    pts = []
    # every cylinder-ish model block, first <pose> inside it
    for m in re.finditer(
            r"<model[^>]*name\s*=\s*['\"][^'\"]*cylinder[^'\"]*['\"]"
            r".*?<pose[^>]*>([-\d.eE\s+]+)</pose>", text, re.S):
        vals = m.group(1).split()
        if len(vals) >= 2:
            pts.append((float(vals[0]), float(vals[1])))
    if not pts:
        raise ValueError(f"no cylinder models found in {path}")
    ij = np.asarray([[round(x / cell_m), round(y / cell_m)] for x, y in pts],
                    np.int64)
    ij -= ij.min(axis=0) - pad_cells
    h, w = ij.max(axis=0) + pad_cells + 1
    grid = np.full((int(h), int(w)), FREE, np.uint8)
    grid[ij[:, 0], ij[:, 1]] = OBST
    return grid


def convert_barn_worlds(world_files, out_dir: str) -> List[str]:
    """Batch-convert real BARN .world files to PNGs for eval/barn.py."""
    os.makedirs(out_dir, exist_ok=True)
    out = []
    for wf in world_files:
        png = os.path.join(
            out_dir, os.path.splitext(os.path.basename(wf))[0] + ".png")
        # save_world_png takes a BOOLEAN obstacle grid (truthy = obstacle);
        # convert_barn_world returns FREE=255/OBST=0 values
        save_world_png(png, convert_barn_world(wf) == OBST)
        out.append(png)
    return out
