"""ETH/UCY pedestrian-trajectory replay: csv -> padded arrays (host numpy
copy of ``img_env_tpu.datasets.pedestrians``).

Re-implements the PedTrajectoryDatasetWrapper pipeline (envs/wrapper/
evaluation_wrapper/PedTrajectoryDatasetWrapper.py:15-156 and the
PrerecordedHuman helpers, :174-288) with identical semantics:

  * csv layout: 4 rows (frame, ped, y, x), i.e. the transpose of a
    [T,4] table (``pd.read_csv(path, header=None).T``);
  * per ped: swap/scale/rotate/offset positions, heading from consecutive
    diffs (last repeated), first row duplicated for the spawn delay;
  * velocities: speed = dist/dt along the path projected on the heading,
    first two samples zero;
  * spawn alignment: each ped's series is front-padded with its first pose
    for ``cur_frame - start_frame`` frames, then subsampled every
    ``skip_frame = control_hz * fps`` frames;
  * all peds of a world padded to the longest series with their last pose.

The output feeds ``NavEnv.reset_fn(..., dataset=(traj, vel, length))`` whose
``dataset`` scene type replays poses verbatim (img_env.cpp:361-386).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PedDatasetConfig:
    path: str = ""
    swapxy: bool = True
    offset: Tuple[float, float, float] = (1.4, 14.4, 0.0)
    fps: int = 15
    skip_frame: Optional[int] = None   # default: control_hz * fps
    control_hz: float = 0.4
    start_t: float = 0.0
    spawn_delay_s: float = 0.0
    max_time: float = 20.0
    scale_x: float = 1.0
    scale_y: float = 1.0

    @property
    def _skip(self) -> int:
        if self.skip_frame is not None:
            return int(self.skip_frame)
        sf = self.control_hz * self.fps
        if abs(sf - round(sf)) > 1e-9:
            raise ValueError("control_hz * fps must be integral")
        return int(round(sf))


def load_trajectory_csv(path: str) -> np.ndarray:
    """[T,4] float array with columns (frame, ped, y, x)."""
    raw = np.loadtxt(path, delimiter=",")
    if raw.ndim != 2:
        raise ValueError(f"unexpected csv shape {raw.shape}")
    if raw.shape[0] == 4 and raw.shape[1] != 4:
        raw = raw.T
    return raw


def _posn_data(xy: np.ndarray, cfg: PedDatasetConfig) -> np.ndarray:
    """[T+1,3] (x, y, theta) after swap/scale/rotate/offset + duplicated head."""
    if cfg.swapxy:
        a, b = xy[:, 1] * cfg.scale_y, xy[:, 0] * cfg.scale_x
    else:
        a, b = xy[:, 0] * cfg.scale_x, xy[:, 1] * cfg.scale_y
    s, c = np.sin(cfg.offset[2]), np.cos(cfg.offset[2])
    px = a * c - b * s + cfg.offset[0]
    py = a * s + b * c + cfg.offset[1]
    th = np.arctan2(np.diff(py), np.diff(px))
    th = np.append(th, th[-1] if th.size else 0.0)
    pos = np.stack([px, py, th], axis=1)
    return np.insert(pos, 0, pos[0], axis=0)


def _times(frames: np.ndarray, start_frame: int, cfg: PedDatasetConfig) -> np.ndarray:
    t = (frames - start_frame) / cfg.fps + cfg.spawn_delay_s + cfg.start_t
    return np.insert(t, 0, t[0] - cfg.start_t)


def _vel_data(times: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """[T,5] rows (x, y, theta, vx, vy); first two samples have zero velocity
    (PrerecordedHuman.gather_vel_data: j>1)."""
    out = np.concatenate([pos, np.zeros((pos.shape[0], 2))], axis=1)
    if pos.shape[0] > 2:
        d = np.linalg.norm(np.diff(pos[:, :2], axis=0), axis=1)
        dt = np.diff(times)
        speed = np.where(dt > 0, d / np.where(dt > 0, dt, 1.0), 0.0)
        out[2:, 3] = speed[1:] * np.cos(pos[2:, 2])
        out[2:, 4] = speed[1:] * np.sin(pos[2:, 2])
    return out


def build_world(
    table: np.ndarray, start_idx: int, max_agents: int, cfg: PedDatasetConfig,
) -> List[np.ndarray]:
    """Per-ped [T_i,5] series for peds start_idx+1 .. start_idx+max_agents."""
    frames, peds = table[:, 0].astype(int), table[:, 1].astype(int)
    series: List[np.ndarray] = []
    start_frame = None
    for i in range(max_agents):
        pid = start_idx + i + 1
        sel = peds == pid
        if not np.any(sel):
            continue
        f_i = frames[sel]
        if start_frame is None:
            start_frame = int(f_i[0])
        if (f_i[0] - start_frame) / cfg.fps > cfg.max_time:
            break
        pos = _posn_data(table[sel][:, 2:4][:, ::-1], cfg)  # (y,x) -> (x,y)
        t = _times(f_i, start_frame, cfg)
        pv = _vel_data(t, pos)
        pad = int(f_i[0]) - start_frame
        pv = np.concatenate([np.repeat(pv[:1], pad, axis=0), pv], axis=0)
        series.append(pv[:: cfg._skip])
    if not series:
        return []
    tmax = max(s.shape[0] for s in series)
    return [
        np.concatenate([s, np.repeat(s[-1:], tmax - s.shape[0], axis=0)])
        for s in series
    ]


def build_world_arrays(
    table: np.ndarray, start_idx: int, max_agents: int, cfg: PedDatasetConfig,
    pad_peds: Optional[int] = None, pad_time: Optional[int] = None,
):
    """Padded (traj [M,T,2], vel [M,T,2], length [M]) for NavEnv reset."""
    series = build_world(table, start_idx, max_agents, cfg)
    m_real = len(series)
    t_real = series[0].shape[0] if series else 1
    m = pad_peds or max(m_real, 1)
    t = pad_time or t_real
    traj = np.zeros((m, t, 2), np.float32)
    vel = np.zeros((m, t, 2), np.float32)
    length = np.ones((m,), np.int32)
    for i, s in enumerate(series[:m]):
        tt = min(s.shape[0], t)
        traj[i, :tt] = s[:tt, 0:2]
        vel[i, :tt] = s[:tt, 3:5]
        if tt < t:  # hold last pose
            traj[i, tt:] = s[tt - 1, 0:2]
            vel[i, tt:] = s[tt - 1, 3:5]
        length[i] = tt
    return traj, vel, length
