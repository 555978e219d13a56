"""Tiny cells for the CPU tests: the benchmark's configurations with their
views, beams, robots and scenes cut to what a CPU test holds, written with
the real traffic and metric files into a temporary checkout."""

from __future__ import annotations

import copy
import json
import os
import shutil

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _load(*parts):
    with open(os.path.join(HERE, *parts), encoding="utf-8") as f:
        return json.load(f)


def tiny_env(name: str) -> dict:
    env = copy.deepcopy(_load("configs", name + ".json")["env"])
    env["view_map"] = {"resolution": 0.05, "width": 3.0, "height": 3.0}
    env["range_total"] = 96
    if env["robot"]["total"] > 1:
        env["robot"] = dict(env["robot"], total=4,
                            begin_poses=[[2.0, 9.0, 2.0, 9.0]],
                            target_poses=[[2.0, 9.0, 2.0, 9.0]])
        env["object"] = dict(env["object"], total=3,
                             poses=[[2.5, 8.5, 2.5, 8.5]])
        env["global_map"] = {"map_file": "room_10.png", "resolution": 0.1}
    return env


def tiny_traffic(name: str) -> dict:
    tr = copy.deepcopy(_load("traffic", name + ".json"))
    if "scenes" in tr:
        tr["scenes"] = 2
        tr["episode_pool"] = 6
    if "mppi" in tr:
        tr["mppi"] = dict(tr["mppi"], samples=8, horizon=4)
    tr["trace_steps"] = 2
    tr["check"] = {"count": 2, "within": 3}
    tr["warmup_steps"] = 1
    return tr


CELLS = {   # cell: (config, traffic)
    "bench200.mppi": ("bench200", "mppi_fleet"),
    "bench200.step": ("bench200", "random_step"),
    "stage5.eval50": ("stage5", "policy_stream50"),
    "stage5.mppi50": ("stage5", "mppi_stream50"),
}


def make_checkout(dst: str, limits: dict = None) -> dict:
    """A checkout under ``dst`` holding the tiny cells; returns its
    benchmark dict (BENCHMARK.json's entries for those cells)."""
    bench = _load_bench()
    nb = os.path.join(dst, "navbench")
    for sub in ("configs", "traffic", "checks"):
        os.makedirs(os.path.join(nb, sub), exist_ok=True)
    for sub in ("metrics", "loops", "actors"):
        shutil.copytree(os.path.join(HERE, sub), os.path.join(nb, sub),
                        dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for cfg in ("bench200", "stage5"):
        raw = _load("configs", cfg + ".json")
        raw["env"] = tiny_env(cfg)
        if raw.get("policy"):   # the checkout holds no program
            raw["policy"] = os.path.join(ROOT, raw["policy"])
        with open(os.path.join(nb, "configs", cfg + ".json"), "w") as f:
            json.dump(raw, f)
    for cell, (_, tr) in CELLS.items():
        with open(os.path.join(nb, "traffic", tr + ".json"), "w") as f:
            json.dump(tiny_traffic(tr), f)
        lim = _load("checks", cell + ".json")
        if limits is not None:
            lim["limits"] = {k: limits.get(k, v)
                             for k, v in lim["limits"].items()}
        with open(os.path.join(nb, "checks", cell + ".json"), "w") as f:
            json.dump(lim, f)
    return bench


# cells whose traffic and check files are kept for a later BENCHMARK.json
# entry, each with the cell whose metrics it would report
QUEUED = {"stage5.mppi50": "stage5.eval50"}


def _load_bench() -> dict:
    """BENCHMARK.json, with the queued cells entered as their files
    describe them."""
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    names = {w["name"] for w in bench["workloads"]}
    for cell, like in QUEUED.items():
        if cell in names:
            continue
        cfg, tr = CELLS[cell]
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": tr, "chips": 1,
                                   "why": "queued"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    return bench
