"""K1-K5 and the EDT alone at production shape on the card: device time per
launch with the host's enqueue hidden, beside each kernel's least bytes and
operations and the least time the card could take on them (its bound).

    python3 tools/kernel_times.py [--out FILE]

The inputs are the card tests' (``card_common.py``): K1 (raster) on
bench200's crowded poses (every odd robot on its even neighbour), K2
(fill) on the packed map of those poses, K3 (paint) and K5 (block paint)
on the thresholds of that fill's raycast, K4 (ped map) at the bench200ped
reset with forced ties; the EDT (csrc/edt.cu, which replaces no TPU kernel)
on the composed obstacle maps of a stage-5 reset (733²) and bench200's
(1066²), both at the resets' clip of 134 cells, with its plain twin's
device ms beside it for the record.  Prints one JSON line: the card's name
and power limit, and per kernel its ms, bytes, operations, bound in µs,
what bounds it (bytes at 3.35 TB/s or operations at 67 T/s, each input read
once and each output written once) and its share (bound over time).  The
EDT's operations are an add and a min for each row candidate the clipped
window needs at these inputs (offsets o with o² below the cell's squared
distance, on both sides, beside the cell's own); ``full_window_us`` is the
bound of the whole window, 2 clip + 1 candidates a cell.  ``--out`` writes
the line to FILE too.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import card_common as cc  # noqa: E402
from img_env_tpu_torch import EnvConfig, NavEnv  # noqa: E402
from img_env_tpu_torch.constants import CELL_FREE_MIN  # noqa: E402
from img_env_tpu_torch.mpc import edt  # noqa: E402
from img_env_tpu_torch.ops import painter, pedmap, polar, raster  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FLAT_OPS_PER_S = 67e12      # H100 SXM float32 rate outside the tensor cores,
                            # taken for the kernels' integer work as well


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps back-to-back launches (after one
    warm-up).  A sleep kernel holds the stream while the host enqueues
    them, so a wrapper whose host work outlasts its kernel is timed by the
    kernel, not by the enqueue rate (the sleep lasts about twice the
    host-side time of the reps, at most 50 ms)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    lead_s = min(2.0 * reps * (time.perf_counter() - t0), 0.05)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(lead_s * 2e9))    # cycles, at most ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def row(ms: float, nbytes_: float, ops: float) -> dict:
    b = nbytes_ / HBM_BYTES_PER_S * 1e6
    o = ops / FLAT_OPS_PER_S * 1e6
    bound_us, by = (b, "bytes") if b >= o else (o, "operations")
    return {"ms": ms, "bytes": int(nbytes_), "ops": int(ops),
            "bound_us": bound_us, "bound_by": by,
            "share": bound_us / 1e3 / ms}


def pedmap_pairs(base, res: float, r_img: float, hs: int) -> int:
    """(ped, pixel) pairs K4 tests: the pixels of each in-window ped's
    index box, clipped to the map."""
    px, py = base[0], base[1]
    half = pedmap.HALF
    in_win = (px <= half) & (px >= -half) & (py <= half) & (py >= -half)
    in_x, in_y = pedmap.pixel_cover_bounds_exact(-px + half, -py + half, res,
                                                 r_img, hs)
    return int((in_x.sum(-1) * in_y.sum(-1) * in_win).sum())


def edt_row(occ, res: float, clip: int) -> dict:
    """The EDT kernel's row at this map, and its twin's device ms."""
    d2 = edt.edt2d_sq_twin(occ, clip)
    roots = torch.ceil(torch.sqrt(d2.double())) - 1    # o with o² < d2
    needed = 1 + 2 * roots.clamp(0, clip)
    out = row(cuda_ms(lambda: edt.edt2d_device(occ, res, clip_cells=clip),
                      50),
              occ.numel() * 5, 2 * float(needed.sum()))
    out["full_window_us"] = (2 * occ.numel() * (2 * clip + 1)
                             / FLAT_OPS_PER_S * 1e6)
    out["twin_ms"] = cuda_ms(lambda: edt.edt2d_twin(occ, res, clip), 2)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_times: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = NavEnv(EnvConfig.from_dict(cc.BENCH200))
    state, _ = env.reset()
    st, t = env.statics, env.tables
    h, w = state.obs_map.shape
    poses = cc.crowded_poses(state.robots.pose)
    out = {}

    cells = raster.world_to_cell(raster.transform_points(
        poses, t.robot_points), st.resolution)
    n, npts = t.robot_mask.shape
    out["K1"] = row(cuda_ms(lambda: raster.robot_maps_kernel(
        cells, t.robot_mask, h, w), 50),
        nbytes(cells, t.robot_mask) + h * w * 4, 4 * n * npts)

    packed = cc.bench200_packed(env, state, poses)
    fargs = cc.fill_args(env, packed, poses)
    nf, n_slots = int(st.polar.n_fill_slots), t.polar.pix_x.shape[0]
    out["K2"] = row(cuda_ms(lambda: polar.fill_sorted_kernel(*fargs), 20),
                    nbytes(packed, t.polar.pix_x[:nf], t.polar.pix_y[:nf])
                    + 4 * 4 * n + n * n_slots,
                    10 * n * nf + 2 * packed.numel())

    s_hit, s_tail = cc.thresholds(env, polar.fill_sorted_kernel(*fargs))
    pst = st.painter
    tests = cc.walk_tests(t.painter, s_hit, s_tail, pst.n_slots)[0]
    v = painter.paint_slots_kernel(t.painter, s_hit, s_tail, pst.n_slots)
    out["K3"] = row(cuda_ms(lambda: painter.paint_slots_kernel(
        t.painter, s_hit, s_tail, pst.n_slots), 20),
        nbytes(s_hit, s_tail, *t.painter.slots, v), 4 * tests + v.numel())

    env_p = NavEnv(EnvConfig.from_dict(cc.BENCH200PED))
    base, _ = cc.pedmap_ties(env_p.reset()[0])
    hs = int(env_p.cfg.ped_image_size[0])
    r_img, res = float(env_p.cfg.ped_image_r), 6.0 / hs
    m = base[0].shape[1]
    out["K4"] = row(cuda_ms(lambda: pedmap.ped_map_kernel(
        *base, res, r_img, hs), 50),
        nbytes(*base) + n * 3 * hs * hs * 4,
        12 * n * m + 8 * pedmap_pairs(base, res, r_img, hs)
        + 4 * n * hs * hs)

    tb = cc.block_tables(env)
    out["K5"] = row(cuda_ms(lambda: painter.paint_blocks_kernel(
        tb, s_hit, s_tail, pst.n_slots), 20),
        nbytes(s_hit, s_tail, *tb.blocks, v),
        4 * tests + tb.blocks[4].numel() + v.numel())

    with open(cc.POLICY_ENV, encoding="utf-8") as f:
        stage5 = NavEnv(EnvConfig.from_dict(json.load(f)))
    res5 = stage5.statics.resolution
    out["edt_733"] = edt_row(stage5.reset()[0].obs_map < CELL_FREE_MIN,
                             res5, 134)
    out["edt_1066"] = edt_row(state.obs_map < CELL_FREE_MIN, st.resolution,
                              134)

    line = json.dumps({"card": cc.card_line(),
                       "device": torch.cuda.get_device_name(0),
                       "kernels": out})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
