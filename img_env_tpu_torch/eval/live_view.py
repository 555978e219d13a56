"""Live interactive viewer — the ``show_gui`` window (img_env.cpp:676-710);
torch port of ``img_env_tpu.eval.live_view``.

The reference pops an OpenCV window per env: the colorized trajectory map
with goal lines, goal circles and index labels on the left, per-robot view
tiles (stacked ``show_robot_num_`` per column) framed in red on the right,
toggled at runtime via the ``show_gui`` ROS param.

``LiveViewer`` reproduces that composite from the existing host-side
renderer (eval/render.py) and shows it through whichever backend is
available — OpenCV ``imshow``, else matplotlib interactive, else headless
(frames still composed, retrievable via ``last_frame`` — what the tests
use).  ``viewer.on = False`` disables updates at runtime like the ROS
param; flipping it back on resumes live display.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from img_env_tpu_torch.eval.render import host, render_frame, render_tiles


def _label(img: np.ndarray, row: int, col: int, text: str,
           color=(255, 0, 0)) -> None:
    """Tiny 3x5 bitmap digits (keeps the panel dependency-free)."""
    font = {
        "0": ["111", "101", "101", "101", "111"],
        "1": ["010", "110", "010", "010", "111"],
        "2": ["111", "001", "111", "100", "111"],
        "3": ["111", "001", "111", "001", "111"],
        "4": ["101", "101", "111", "001", "001"],
        "5": ["111", "100", "111", "001", "111"],
        "6": ["111", "100", "111", "101", "111"],
        "7": ["111", "001", "010", "010", "010"],
        "8": ["111", "101", "111", "101", "111"],
        "9": ["111", "101", "111", "001", "111"],
    }
    x = col
    for ch in text:
        pat = font.get(ch)
        if pat is None:
            x += 4
            continue
        for r, line in enumerate(pat):
            for c, bit in enumerate(line):
                if bit == "1":
                    rr, cc = row + r, x + c
                    if 0 <= rr < img.shape[0] and 0 <= cc < img.shape[1]:
                        img[rr, cc] = color
        x += 4


def compose_gui(state, statics, sensor_maps, cfg,
                window_height: int = 480, tile: int = 96,
                per_col: int = 5) -> np.ndarray:
    """One show_gui composite frame: map+goals left, framed view tiles right."""
    beep_r = float(getattr(cfg, "beep_r", 0.0)) or None
    frame = render_frame(
        state, statics,
        robot_radius=float(getattr(cfg, "robot_radius", 0.17)),
        beep_radius=beep_r)
    # resize map panel to window_height (nearest neighbour)
    h, w = frame.shape[:2]
    scale = window_height / h
    ww = max(int(round(w * scale)), 1)
    ys = np.clip((np.arange(window_height) / scale).astype(int), 0, h - 1)
    xs = np.clip((np.arange(ww) / scale).astype(int), 0, w - 1)
    left = frame[ys][:, xs]

    # goal index labels (img_env.cpp:690)
    res = float(statics.resolution)
    goals = host(state.robots.goal)
    for i in range(goals.shape[0]):
        gy = int(round(goals[i, 0] / res * scale))
        gx = int(round(goals[i, 1] / res * scale))
        _label(left, gy + 4, gx + 4, str(i))

    tiles = render_tiles(sensor_maps, tile=tile, per_col=per_col)
    n = len(sensor_maps)
    for i in range(n):
        r, c = i % per_col, i // per_col
        # red tile frame + index (img_env.cpp:704-707)
        tiles[r * tile, c * tile:(c + 1) * tile] = (255, 0, 0)
        tiles[min((r + 1) * tile, tiles.shape[0]) - 1,
              c * tile:(c + 1) * tile] = (255, 0, 0)
        tiles[r * tile:(r + 1) * tile, c * tile] = (255, 0, 0)
        tiles[r * tile:(r + 1) * tile,
              min((c + 1) * tile, tiles.shape[1]) - 1] = (255, 0, 0)
        _label(tiles, (r + 1) * tile - 8, c * tile + 4, str(i))

    hh = max(window_height, tiles.shape[0])
    out = np.full((hh, ww + tiles.shape[1], 3), 200, np.uint8)
    out[:window_height, :ww] = left
    out[: tiles.shape[0], ww:] = tiles
    return out


class LiveViewer:
    """Interactive window fed one (state, sensor_maps) pair per step.

    ``on`` can be flipped at runtime (the show_gui param,
    img_env.cpp:163); backend 'auto' tries cv2 then matplotlib, 'none' is
    headless (composites only).
    """

    def __init__(self, statics, cfg, backend: str = "auto",
                 window: str = "img_env_tpu", window_height: int = 480):
        self.statics = statics
        self.cfg = cfg
        self.window = window
        self.window_height = window_height
        self.on = True
        self.last_frame: Optional[np.ndarray] = None
        self._mpl_im = None
        self.backend = self._pick(backend)

    def _pick(self, backend: str) -> str:
        if backend != "auto":
            return backend
        try:
            import cv2  # noqa: F401

            return "cv2"
        except Exception:
            pass
        try:
            import matplotlib

            matplotlib.get_backend()
            return "mpl"
        except Exception:
            return "none"

    def update(self, state, sensor_maps) -> Optional[np.ndarray]:
        if not self.on:
            return None
        img = compose_gui(state, self.statics, sensor_maps, self.cfg,
                          window_height=self.window_height)
        self.last_frame = img
        if self.backend == "cv2":
            import cv2

            try:
                cv2.imshow(self.window, img[..., ::-1])
                cv2.waitKey(1)
            except cv2.error:          # no display server -> go headless
                self.backend = "none"
        elif self.backend == "mpl":
            import matplotlib.pyplot as plt

            if self._mpl_im is None:
                plt.ion()
                _, ax = plt.subplots(num=self.window)
                self._mpl_im = ax.imshow(img)
                ax.axis("off")
            else:
                self._mpl_im.set_data(img)
            plt.pause(0.001)
        return img

    def close(self) -> None:
        if self.backend == "cv2":
            import cv2

            cv2.destroyWindow(self.window)
        elif self.backend == "mpl" and self._mpl_im is not None:
            import matplotlib.pyplot as plt

            plt.close(self.window)
