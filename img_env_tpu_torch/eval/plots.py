"""Offline episode analysis plots — the BagReader figure suite
(envs/utils/bag/bag.py:897-1109) over EpisodeRecorder npz records (torch
port of ``img_env_tpu.eval.plots``).

The figure functions take an ``EpisodeRecorder`` (or its loaded npz) and
render matplotlib figures: trajectory overlays on the map, velocity
profiles, outcome summaries.  matplotlib is imported lazily, so the
indicator table (``per_robot_indicators``, ``comparison_table``,
``write_comparison_csv``) runs where it is not installed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectories(recorder, statics=None, out: Optional[str] = None,
                      max_episodes: int = 20):
    """Robot (and ped) trajectories of each episode, overlaid on the map."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 7))
    if statics is not None:
        occ = np.asarray(statics.static_map) < 250
        res = float(statics.resolution)
        ax.imshow(
            ~occ, cmap="gray", origin="lower",
            extent=(0, occ.shape[1] * res, 0, occ.shape[0] * res), alpha=0.6)
    for e in recorder.episodes[:max_episodes]:
        if not e.robot_poses:
            continue
        poses = np.asarray(e.robot_poses)     # [T,N,3]
        for i in range(poses.shape[1]):
            ax.plot(poses[:, i, 1], poses[:, i, 0], lw=1.2)
            ax.plot(poses[0, i, 1], poses[0, i, 0], "g^", ms=5)
            ax.plot(poses[-1, i, 1], poses[-1, i, 0], "r*", ms=7)
        peds = np.asarray(e.ped_poses)
        if peds.size:
            for j in range(peds.shape[1]):
                ax.plot(peds[:, j, 1], peds[:, j, 0], "--", lw=0.7, alpha=0.5)
    ax.set_xlabel("y [m]")
    ax.set_ylabel("x [m]")
    ax.set_title("episode trajectories")
    ax.set_aspect("equal")
    if out:
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out
    return fig


def _star_points(center, r1: float, r2: float) -> np.ndarray:
    """5-pointed star polygon alternating outer/inner radii (the goal/final
    markers of bag.py's trajectory figures)."""
    import math

    pts = []
    for k in range(10):
        r = r1 if k % 2 == 0 else r2
        a = math.pi / 2 + k * math.pi / 5
        pts.append([center[0] + r * math.cos(a), center[1] + r * math.sin(a)])
    return np.asarray(pts)


def _darker(color, f: float):
    return tuple(c * f for c in color[:3])


_PLOT_COLORS = ["tab:blue", "tab:orange", "tab:green", "tab:purple",
                "tab:brown", "tab:pink", "tab:olive", "tab:cyan",
                "gold", "tab:red"]


def plot_ep_split(recorder, statics=None, out: Optional[str] = None,
                  robot_radius: float = 0.17, reach_th: float = 0.3,
                  robot_every_circle: bool = True, max_episodes: int = 9):
    """Episode-split trajectory composite in the reference's publication
    style (bag.py:447-613 `_plot_t_ep` / `draw_trajectory(ep_split=True)`):
    one panel per episode with robot footprint circles alpha-ramped
    0.2->0.8 along the path (red final disc on collision), pedestrian discs
    every 4th step plus center dots, hatched goal stars, and a black
    line to the unreached goal (dashed on collision, solid on stuck)."""
    import math

    import matplotlib.colors as mcolors

    plt = _plt()
    eps = [e for e in recorder.episodes[:max_episodes] if e.robot_poses]
    if not eps:
        raise ValueError("no recorded episodes to plot")
    ncol = int(math.ceil(math.sqrt(len(eps))))
    nrow = int(math.ceil(len(eps) / ncol))
    fig, axes = plt.subplots(nrow, ncol, figsize=(4.2 * ncol, 4.2 * nrow),
                             squeeze=False)
    star_r1 = robot_radius / 1.8
    star_r2 = star_r1 / 3

    for ei, e in enumerate(eps):
        ax = axes[ei // ncol][ei % ncol]
        if statics is not None:
            occ = np.asarray(statics.static_map) < 250
            res = float(statics.resolution)
            ax.imshow(~occ, cmap="gray", origin="lower",
                      extent=(0, occ.shape[1] * res, 0, occ.shape[0] * res),
                      alpha=0.6)
        poses = np.asarray(e.robot_poses)        # [T,N,3]
        peds = np.asarray(e.ped_poses)           # [T,M,2]
        T, N = poses.shape[0], poses.shape[1]
        M = peds.shape[1] if peds.size else 0
        codes = (np.asarray(e.dones_info).reshape(-1)
                 if e.dones_info is not None else np.zeros(N))
        alpha = np.linspace(0.2, 0.8, T + 1)[1:]

        for r in range(N):
            col = mcolors.to_rgb(_PLOT_COLORS[r % len(_PLOT_COLORS)])
            coll = codes[r] in (1, 2, 3) if r < len(codes) else False
            stuck = codes[r] == 10 if r < len(codes) else False
            arrived = codes[r] == 5 if r < len(codes) else False
            xs, ys = poses[:, r, 1], poses[:, r, 0]   # (y,x) plot frame
            for i in range(T):
                if not robot_every_circle and i % 4 != 0 and i != T - 1:
                    continue
                c = (_darker(mcolors.to_rgb("tab:red"), alpha[i])
                     if (coll and i == T - 1) else _darker(col, alpha[i]))
                ax.add_artist(plt.Circle((xs[i], ys[i]),
                                         radius=robot_radius, alpha=0.8,
                                         color=c, ec=None))
            goal = (np.asarray(e.goals)[r][:2]
                    if e.goals is not None else poses[-1, r, :2])
            gxy = (goal[1], goal[0])
            if arrived:
                gxy = (xs[-1], ys[-1])
            ax.add_artist(plt.Polygon(
                _star_points(gxy, star_r1, star_r2), closed=True,
                color=col, linewidth=0.5, fill=True, hatch="/"))
            ax.plot(xs, ys, color=col, linewidth=0.5, alpha=0.8)
            if coll or stuck:
                ax.plot([xs[-1], gxy[0]], [ys[-1], gxy[1]], color="black",
                        linewidth=0.5,
                        linestyle="dashed" if coll else "solid")
        for p in range(M):
            col = mcolors.to_rgb(
                _PLOT_COLORS[(p + N) % len(_PLOT_COLORS)])
            xs, ys = peds[:, p, 1], peds[:, p, 0]
            for i in range(T):
                if i % 4 == 0:
                    ax.add_artist(plt.Circle(
                        (xs[i], ys[i]), radius=0.1, alpha=0.6,
                        facecolor=_darker(col, alpha[i]),
                        edgecolor=_darker((0, 0.5, 1), alpha[i]),
                        linewidth=0.2))
                ax.add_artist(plt.Circle(
                    (xs[i], ys[i]), radius=0.03, alpha=1.0,
                    facecolor=_darker(col, alpha[i]),
                    edgecolor=_darker((0, 0.5, 1), alpha[i]),
                    linewidth=0.2))
            ax.add_artist(plt.Polygon(
                _star_points((xs[-1], ys[-1]), star_r1, star_r2),
                closed=True, color=col, linewidth=0.5, fill=True,
                hatch="/"))
            ax.plot(xs, ys, color=col, linewidth=0.5, alpha=0.8)
        ax.set_xlabel("y [m]")
        ax.set_ylabel("x [m]")
        ax.set_title(f"episode {ei}", fontsize=10)
        ax.set_aspect("equal", "box")
    for k in range(len(eps), nrow * ncol):
        axes[k // ncol][k % ncol].axis("off")
    fig.tight_layout()
    if out:
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out
    return fig


def plot_vw_odom(recorder, episode: int = 0, robot: int = 0,
                 out: Optional[str] = None):
    """2x2 commanded-vs-executed velocity figure (bag.py:751-896
    `draw_vw(data_source='vw')`): top row the commanded v/w with point
    markers, bottom row the executed ("odom") v/w derived from the recorded
    pose history — the simulator analogue of the reference's /odom twist."""
    plt = _plt()
    e = recorder.episodes[episode]
    vw = np.asarray(e.robot_vws)[:, robot]        # [T,2] commands
    poses = np.asarray(e.robot_poses)[:, robot]   # [T,3]
    dt = recorder.dt
    t = np.arange(vw.shape[0]) * dt
    d = np.diff(poses, axis=0)
    heading = poses[:-1, 2]
    v_odom = (d[:, 0] * np.cos(heading) + d[:, 1] * np.sin(heading)) / dt
    w_odom = (np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))) / dt
    t_odom = t[1:]
    fig, ax = plt.subplots(nrows=2, ncols=2, constrained_layout=True,
                           figsize=(9, 5))
    fig.suptitle(
        f"Robot Velocities of (Episode {episode}, Robot {robot})",
        fontsize=14)
    ax[0][0].plot(t, vw[:, 0], marker="o")
    ax[0][0].set_ylabel("control_vs [m/s]")
    ax[0][1].plot(t, vw[:, 1], marker="o")
    ax[0][1].set_ylabel("control_ws [rad/s]")
    ax[1][0].plot(t_odom, v_odom)
    ax[1][0].set_ylabel("odom_vs [m/s]")
    ax[1][0].set_xlabel("time [s]")
    ax[1][1].plot(t_odom, w_odom)
    ax[1][1].set_ylabel("odom_ws [rad/s]")
    ax[1][1].set_xlabel("time [s]")
    if out:
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out
    return fig


def plot_vw_curves(recorder, episode: int = 0, out: Optional[str] = None):
    """v / w command curves for one episode (bag.py vw plots)."""
    plt = _plt()
    e = recorder.episodes[episode]
    vw = np.asarray(e.robot_vws)             # [T,N,2]
    t = np.arange(vw.shape[0]) * recorder.dt
    fig, (a1, a2) = plt.subplots(2, 1, figsize=(8, 5), sharex=True)
    for i in range(vw.shape[1]):
        a1.plot(t, vw[:, i, 0], label=f"robot {i}")
        a2.plot(t, vw[:, i, 1])
    a1.set_ylabel("v [m/s]")
    a2.set_ylabel("w [rad/s]")
    a2.set_xlabel("t [s]")
    a1.legend(loc="upper right", fontsize=7)
    if out:
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out
    return fig


def plot_outcomes(recorder, out: Optional[str] = None):
    """Bar chart of dones_info outcomes across episodes."""
    plt = _plt()
    names = {1: "static coll", 2: "ped coll", 3: "robot coll",
             5: "arrive", 10: "timeout"}
    counts = {k: 0 for k in names}
    for e in recorder.episodes:
        if e.dones_info is None:
            continue
        for d in np.asarray(e.dones_info).reshape(-1):
            if int(d) in counts:
                counts[int(d)] += 1
    fig, ax = plt.subplots(figsize=(6, 3.5))
    ax.bar([names[k] for k in counts], list(counts.values()))
    ax.set_ylabel("episodes")
    if out:
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out
    return fig


# ---------------------------------------------------------------------------
# BagReader indicator + multi-method comparison surface (bag.py:897-1109)
# ---------------------------------------------------------------------------


def per_robot_indicators(recorder, v_max: float = 0.6,
                         reach_th: float = 0.3) -> dict:
    """Per-robot + aggregate indicator table (BagReader.cal_indicator).

    Mirrors bag.py:897-1040: rates over arrive+collision outcomes, stuck
    rate over all episodes, and — conditioned on ARRIVED robots — arrival
    time/distance and the extra time/distance beyond the straight
    start->goal optimum (minus reach_th, at v_max).  v/w stats pool the
    arrived robots' command curves.
    """
    eps = [e for e in recorder.episodes if e.robot_poses]
    if not eps:
        return {}
    n = np.asarray(eps[0].robot_poses).shape[1]
    arr = np.zeros(n, int)
    coll = np.zeros(n, int)
    stuck = np.zeros(n, int)
    times = [[] for _ in range(n)]
    dists = [[] for _ in range(n)]
    extra_t = [[] for _ in range(n)]
    extra_d = [[] for _ in range(n)]
    vs, ws = [], []
    for e in eps:
        poses = np.asarray(e.robot_poses)          # [T,N,3]
        vws = np.asarray(e.robot_vws)
        done = (np.asarray(e.dones_info).reshape(-1)
                if e.dones_info is not None else np.zeros(n))
        for i in range(n):
            d = int(done[i]) if done.size > i else 0
            if d in (1, 2, 3):
                coll[i] += 1
                continue
            if d == 10:
                stuck[i] += 1
                continue
            if e.goals is None:
                continue
            goal = np.asarray(e.goals)[i]
            gd = np.linalg.norm(poses[:, i, :2] - goal, axis=-1)
            hit = np.nonzero(gd <= reach_th)[0]
            if d != 5 and hit.size == 0:
                continue
            arr[i] += 1
            t_end = int(hit[0]) + 1 if hit.size else poses.shape[0]
            seg = np.linalg.norm(np.diff(poses[:t_end, i, :2], axis=0),
                                 axis=-1)
            path = float(seg.sum())
            t_arr = t_end * recorder.dt
            straight = float(np.linalg.norm(goal - poses[0, i, :2])) - reach_th
            times[i].append(t_arr)
            dists[i].append(path)
            extra_t[i].append(t_arr - straight / v_max)
            extra_d[i].append(path - straight)
            if vws.size:
                vs += list(vws[:t_end, i, 0])
                ws += list(vws[:t_end, i, 1])

    def _ms(x):
        x = np.asarray(x, np.float64)
        return (float(x.mean()), float(x.std())) if x.size else (0.0, 0.0)

    rows = {}
    for i in range(n):
        den = max(arr[i] + coll[i], 1)
        rows[i] = {
            "arrive_rate": arr[i] / den,
            "collision_rate": coll[i] / den,
            "stuck_rate": stuck[i] / len(eps),
            "time": _ms(times[i]),
            "distance": _ms(dists[i]),
            "extra_time": _ms(extra_t[i]),
            "extra_distance": _ms(extra_d[i]),
        }
    den = max(arr.sum() + coll.sum(), 1)
    rows["all"] = {
        "arrive_rate": arr.sum() / den,
        "collision_rate": coll.sum() / den,
        "stuck_rate": stuck.sum() / (len(eps) * n),
        "time": _ms(sum(times, [])),
        "distance": _ms(sum(dists, [])),
        "extra_time": _ms(sum(extra_t, [])),
        "extra_distance": _ms(sum(extra_d, [])),
        "v": _ms(vs),
        "w": _ms(ws),
    }
    return rows


def comparison_table(recorders: dict, v_max: float = 0.6,
                     reach_th: float = 0.3) -> dict:
    """{method: aggregate indicator row} of ``per_robot_indicators``."""
    return {name: per_robot_indicators(rec, v_max, reach_th)["all"]
            for name, rec in recorders.items()}


COMPARISON_COLS = ["arrive_rate", "collision_rate", "stuck_rate", "time",
                   "distance", "extra_time", "extra_distance", "v", "w"]


def write_comparison_csv(table: dict, path: str) -> None:
    """The BagReader indicator table as csv: a rate per column, a
    (mean, std) pair as two."""
    lines = ["method," + ",".join(
        c if c.endswith("rate") else f"{c}_mean,{c}_std"
        for c in COMPARISON_COLS)]
    for name, row_in in table.items():
        row = [name]
        for c in COMPARISON_COLS:
            val = row_in.get(c, 0.0)
            if isinstance(val, tuple):
                row += [f"{val[0]:.4f}", f"{val[1]:.4f}"]
            else:
                row.append(f"{val:.4f}")
        lines.append(",".join(row))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def compare_methods(recorders: dict, out_dir: str, statics=None,
                    v_max: float = 0.6, reach_th: float = 0.3,
                    figures: bool = True) -> dict:
    """Multi-method A/B comparison (the BagReader multi-bag workflow).

    recorders: {method_name: EpisodeRecorder} recorded on the SAME
    scenario bank (cfg_type 'bag' replay).  Writes the indicator table as
    ``comparison.csv`` under out_dir (numpy only), then with ``figures``
    per-method trajectory figures, v/w figures and a comparison bar figure
    (these need matplotlib: ImportError without it); returns {method:
    aggregate indicator row}.
    """
    import os

    os.makedirs(out_dir, exist_ok=True)
    table = comparison_table(recorders, v_max, reach_th)
    write_comparison_csv(table, os.path.join(out_dir, "comparison.csv"))
    if not figures:
        return table
    plt = _plt()
    for name, rec in recorders.items():
        plot_trajectories(rec, statics,
                          out=os.path.join(out_dir, f"traj_{name}.png"))
        if rec.episodes and rec.episodes[0].robot_vws:
            plot_vw_curves(rec, 0, out=os.path.join(out_dir, f"vw_{name}.png"))

    metrics = ["arrive_rate", "collision_rate", "stuck_rate"]
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    names = list(table)
    for k in metrics:
        axes[0].bar([f"{n}\n{k}" for n in names],
                    [table[n][k] for n in names], label=k)
    axes[0].set_title("outcome rates")
    width = 0.35
    xs = np.arange(len(names))
    axes[1].bar(xs - width / 2, [table[n]["extra_time"][0] for n in names],
                width, yerr=[table[n]["extra_time"][1] for n in names],
                label="extra time [s]")
    axes[1].bar(xs + width / 2,
                [table[n]["extra_distance"][0] for n in names], width,
                yerr=[table[n]["extra_distance"][1] for n in names],
                label="extra distance [m]")
    axes[1].set_xticks(xs)
    axes[1].set_xticklabels(names)
    axes[1].legend()
    axes[1].set_title("efficiency (arrived episodes)")
    fig.savefig(os.path.join(out_dir, "comparison.png"), dpi=120,
                bbox_inches="tight")
    plt.close(fig)
    return table
