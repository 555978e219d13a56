"""Time the slot-row K3 painter (the csrc/paint.cu before the slot-order
redesign) on three subsets of its row table at bench200, on one NVIDIA
GPU.

    python3 tools/k3_row_subsets.py --tree DIR [--out FILE]

``DIR`` is a checkout of a tree whose painter has the slot-row layout
(``painter.PaintRows``, ``painter.paint_rows_kernel``): the commit before
the slot-order redesign, e.g. unpacked with ``git archive`` into a
gitignored directory.  The script imports ``img_env_tpu_torch`` from there.

The row table is an input of the kernel, so each subset is a row table of
its own, launched alone into the full output:

  * dense: the packs of near-sensor "wide" slots, windows over all beams;
  * empty: the packs of slots no beam visits (window width 0);
  * rest: every other row (the PaintT groups, windows of <= 256 beams).

Thresholds come from the bench200 reset with every odd robot pushed onto
its even neighbour (as chip_smoke.py's selfcheck).  Also times the tree's
K2 fill on the same map and poses, and prints, for the same thresholds,
what a descending-beam walk with early exit per slot would test: visits
per slot and tests per (robot, slot).  Prints one JSON line; with
``--out`` also writes it there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("k3_row_subsets: no CUDA device")
    import chip_smoke as cs     # the tree's own smoke script: configs, timing
    from img_env_tpu_torch import EnvConfig, NavEnv
    from img_env_tpu_torch.ops import painter, polar, raster

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    env = NavEnv(EnvConfig.from_dict(cs.BENCH200), "cuda")
    state, _ = env.reset()
    st, t = env.statics, env.tables
    res = st.resolution
    poses = state.robots.pose.clone()
    poses[1::2, :2] = poses[0::2, :2] + 0.1
    layers = raster.build_layers(
        state.obs_map, res, poses, t.robot_points, t.robot_mask,
        torch.zeros((0, 3), device=poses.device),
        *([torch.zeros((0, 1, 2), device=poses.device),
           torch.zeros((0, 1), dtype=torch.bool, device=poses.device)] * 3))
    occ = polar.fill_sorted(st.polar, t.polar, layers.packed, poses, res)
    fill_ms = cs.cuda_ms(lambda: polar.fill_sorted(
        st.polar, t.polar, layers.packed, poses, res), args.reps)
    _, _, aux = polar.raycast_batched(st.polar, t.polar, occ)
    s_hit, s_tail = painter.hit_steps(st.painter, t.painter, *aux)
    n_beams = st.view_params.range_total
    rows = painter.PaintRows.build(st.paint_t, n_beams)
    n_slots = st.painter.n_slots

    def subset(sel):
        idx = np.nonzero(sel)[0]
        w = rows.w[idx]
        tab = [rows.table[rows.off[i]:rows.off[i] + rows.w[i]] for i in idx]
        sub = painter.PaintRows(
            slots=rows.slots[idx], rb=rows.rb[idx], w=w,
            off=np.concatenate([[0], np.cumsum(w)[:-1]]).astype(np.int64),
            table=np.ascontiguousarray(np.concatenate(tab, axis=0))
            if tab else np.zeros((0, painter.G8), np.int16))
        return painter.make_painter_tables(st.painter, sub, "cuda")

    dense = rows.w == n_beams
    empty = rows.w == 0
    parts = {"all": np.ones_like(dense), "dense": dense, "empty": empty,
             "rest": ~(dense | empty)}
    out = {"card": card, "rows": int(len(rows.w)), "k2_fill_ms": fill_ms,
           "parts": {}}
    for name, sel in parts.items():
        tb = subset(sel)
        ms = cs.cuda_ms(lambda: painter.paint_rows_kernel(
            tb, s_hit, s_tail, n_slots), args.reps)
        nslot = int((rows.slots[sel] >= 0).sum())
        out["parts"][name] = {"rows": int(sel.sum()), "slots": nslot,
                              "window_beams": int(rows.w[sel].sum()),
                              "ms": ms}
        cs.log(f"# K3 rows {name}: {int(sel.sum())} rows, {nslot} slots, "
               f"{int(rows.w[sel].sum())} window beams, {ms:.4f} ms")

    # a descending-beam walk with early exit: visits and tests per slot
    r_i, g_i = np.nonzero(rows.table)
    row_of = np.repeat(np.arange(len(rows.w)), rows.w)[r_i]
    beam = rows.rb[row_of] + (r_i - rows.off[row_of])
    slot = rows.slots[row_of, g_i]
    T = rows.table[r_i, g_i].astype(np.int64)
    order = np.lexsort((-beam, slot))
    slot, beam, T = slot[order], beam[order], T[order]
    counts = np.bincount(slot, minlength=n_slots)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(slot)) - first[slot]
    dev = s_hit.device
    sh = s_hit.long()[:, torch.as_tensor(beam, device=dev)]
    stl = s_tail.long()[:, torch.as_tensor(beam, device=dev)]
    Tt = torch.as_tensor(T, device=dev)[None]
    writes = (Tt <= sh) | (Tt == sh + 1) | (Tt > stl)
    cnt = torch.as_tensor(counts, device=dev)
    slot_t = torch.as_tensor(slot, device=dev)
    need = torch.where(writes, torch.as_tensor(pos, device=dev)[None] + 1,
                       cnt[slot_t][None])
    tests = torch.full((s_hit.shape[0], n_slots), 1 << 30, device=dev,
                       dtype=torch.int64).scatter_reduce(
        1, slot_t[None].expand_as(need), need, "amin", include_self=True)
    tests = torch.where(cnt[None] == 0, torch.zeros_like(tests),
                        torch.minimum(tests, cnt[None]))
    out["walk"] = {
        "visits": int(len(slot)), "slots_visited": int((counts > 0).sum()),
        "max_visits_per_slot": int(counts.max()),
        "slots_over_256_visits": int((counts > 256).sum()),
        "tests_per_robot": float(tests.sum()) / s_hit.shape[0],
        "max_tests": int(tests.max()),
        "occupied_gated_share": float(occ[:, :st.polar.n_fill_slots]
                                      .float().mean())}
    cs.log(f"# descending walk: {out['walk']}")
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
