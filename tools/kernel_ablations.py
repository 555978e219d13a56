"""Where K1's, K2's, K3's, K4's and K5's time goes, on one NVIDIA GPU.

    python3 tools/kernel_ablations.py [--tree DIR] [--reps 30] [--out FILE]

Builds the kernels of ``DIR/img_env_tpu_torch/csrc`` (default: this
repository) as they are and, from the same sources with one part cut out
(text substitutions, checked to apply), ablated copies that give wrong
maps on purpose.  A cut lists one variant per kernel design (K1: the
memset design, a cudaMemsetAsync then one block per robot, and the
dependent-launch design, a clear kernel then the raster kernel as its
programmatic dependent; K4: the key design's cuts only); the first
whose every substitution applies once is taken, and a cut that fits no
variant of the tree's source is reported under ``skipped``:

  * K1 ``clear only``: the map is cleared and no robot is rasterized
    (the memset design: the memset alone; the dependent-launch design:
    the clear kernel alone);
  * K1 ``no overlap`` (dependent-launch design): the raster kernel is
    launched as an ordinary kernel after the clear, not as its
    programmatic dependent;
  * K1 ``no corner pass``: the bitmap window's corner is one point's cell
    minus 64 (the memset design: the robot's first point; the
    dependent-launch design: lane 0's own min per warp) instead of the min over the robot's points;
  * K1 ``no global atomics``: the distinct cells are found but never
    added to the map;
  * K4 ``no scatter``: the peds are read, tested and listed, the map is
    cleared and stored, but no (ped, pixel) pair is tested;
  * K4 ``stores only``: no ped is read, every pixel is stored empty;
  * K4 ``256 threads``: blocks of 256 threads instead of 512 (what the
    wider block buys);
  * K3 ``no walks``: the slots a thread's first two visits leave undecided
    are never walked (the warp-cooperative walk's cost);
  * K3 ``no tests``: every slot is written 200 without a test (the store
    floor, with the prologue and the threshold staging);
  * K2 ``no map reads``: the packed map is never read, a set bit counts as
    occupied (the cost of the own-cell test's reads);
  * K2 ``stores only``: no slot arithmetic, the pre-pass and the bitmap
    staging kept (the cost of the per-slot arithmetic, as the difference);
  * K5 ``stores only``: every block is written 200 as a constant-200
    block is (no table, no threshold, no test: the store floor);
  * K5 ``constant-200 blocks only``: the blocks with a window return at
    once (the constant blocks' stores alone);
  * K5 ``wide blocks only``: only the blocks whose window is wider than
    ``painter.NARROW_W`` (the 1024-wide blocks, the pack of wide slots, the
    256-wide blocks) run;
  * K5 ``no early exit``: every slot with more than two visits is walked
    by its warp to the end of its list, the first writer not ending the
    walk (what the descending walk's early exit saves).

Also measures the packed-map composition (``raster.pack_layers``, the
elementwise passes over the map that follow K1) at the bench200ped reset:
its device operations and device ms per call.

The inputs are chip_smoke.py's: K1 on the crowded bench200 poses, K2 and
K3 on their packed map and thresholds, K5 on the same thresholds through
the gen-1 blocks, K4 on the bench200ped ties case.  K5 is timed only on a
tree whose K5 reads s_hit / s_tail as int16 [N, R] (the block layout's
``PainterTables.block_sizes``); on an older tree it is listed under
``skipped``.
Each C entry point is timed with ``chip_smoke.cuda_ms`` (device time, the
host's enqueue hidden behind a sleep kernel), in turns: the kernels, the
ablations, then again in reverse.  K1's and K4's wrappers are also timed
both ways: ``cuda_ms``, and events around a plain loop of calls, which is
paced by the host when the wrapper's host work outlasts its kernel.  Also
times the device parts of K1 and K2 with torch.profiler.  Prints one JSON
line; with ``--out`` also writes it there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ABLATIONS = {
    "raster": {   # variants: the memset design, then the dependent launch
        "clear only": (
            (("  if (n > 0 && p > 0) {", "  if (false) {"),),
            (("  if (err != cudaSuccess || n <= 0 || p <= 0) return (int)err;",
              "  return (int)err;"),),
        ),
        "no overlap": (
            (("  attr.val.programmaticStreamSerializationAllowed = 1;",
              "  attr.val.programmaticStreamSerializationAllowed = 0;"),),
        ),
        "no corner pass": (
            (("    m0 = INT_MAX;\n    n0 = INT_MAX;",
              "    m0 = cells[(size_t)r * p * 2] - 64;\n"
              "    n0 = cells[(size_t)r * p * 2 + 1] - 64;"),
             ("      atomicMin(&m0, m);\n      atomicMin(&n0, n);", "")),
            (("  const int wm = __reduce_min_sync(0xffffffffu, mloc);\n"
              "  const int wn = __reduce_min_sync(0xffffffffu, nloc);",
              "  const int wm = mloc - 64, wn = nloc - 64;"),),
        ),
        "no global atomics": (
            (("    if (!(old & mask)) atomicAdd(",
              "    if (!(old & mask) && r < 0) atomicAdd("),),
            (("        atomicAdd(&out[(size_t)a[k].x * w + a[k].y], contrib);",
              "        ;"),
             ("      atomicAdd(&out[(size_t)b.x * w + b.y], contrib);",
              "      ;")),
        ),
    },
    "pedmap": {
        "no scatter": (
            (("    for (int c = warp; c < cnt; c += PM_WARPS) {",
              "    for (int c = warp; c < 0; c += PM_WARPS) {"),),
        ),
        "256 threads": (
            (("#define PM_THREADS 512", "#define PM_THREADS 256"),
             ("#define PM_WARPS (PM_THREADS / 32)",    # the key design only
              "#define PM_WARPS (PM_THREADS / 32)")),
        ),
        "stores only": (
            (("  for (int base = 0; base < m; base += PM_THREADS, ++tile) {",
              "  for (int base = 0; base < 0; base += PM_THREADS, ++tile) {"),),
        ),
    },
    "paint": {
        "no walks": (
            (("        else if (lo[k] + 2 < lo[k + 1]) pend |= 1u << k;",
              "        else if (false) pend |= 1u << k;"),),
        ),
        "no tests": (
            (("      if (lo[k] < lo[k + 1]) {\n"
              "        float x = visit_value(first[k], th);",
              "      if (false) {\n"
              "        float x = visit_value(first[k], th);"),),
        ),
    },
    "paint_block": {
        "stores only": (
            (("  if (w == 0) {\n    paint_constant(",
              "  if (true) {\n    paint_constant("),),
        ),
        "constant-200 blocks only": (
            (("    paint_constant(slots, r0, nr, out, n_slots);\n    return;\n  }\n",
              "    paint_constant(slots, r0, nr, out, n_slots);\n    return;\n  }\n"
              "  return;\n"),),
        ),
        "wide blocks only": (
            (("  const int w = blk_w[blk], rb = blk_rb[blk];",
              "  if (!wide) return;\n"
              "  const int w = blk_w[blk], rb = blk_rb[blk];"),),
        ),
        "no early exit": (
            (("      else pend = a + 2 < b;", "      pend = a + 2 < b;"),
             ("          res = __shfl_sync(FULL_MASK, x, __ffs(wr) - 1);\n"
              "          break;",
              "          res = __shfl_sync(FULL_MASK, x, __ffs(wr) - 1);")),
        ),
    },
    "fill": {
        "no map reads": (
            (("  const int v = set ? __ldg(map + (size_t)cm * w + cn) : 1;",
              "  const int v = 1;"),),
        ),
        "stores only": ((("    if (j0 < n_fill) {", "    if (false) {"),),),
    },
}


def ablate(src: str, variants):
    """``src`` with the first variant whose every substitution applies
    exactly once, or None."""
    for subs in variants:
        if all(src.count(old) == 1 for old, _ in subs):
            for old, new in subs:
                src = src.replace(old, new)
            return src
    return None


def paced_ms(fn, reps: int) -> float:
    """Events around a plain loop of ``reps`` calls (after one warm-up):
    the host's enqueue rate when it is slower than the device."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_parts(fn, reps: int = 10) -> dict:
    """Mean device time per call of each device operation of fn()."""
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / reps / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def pack_cost(env, state, reps: int = 10) -> dict:
    """Device operations and device ms per call of the packed-map
    composition (``raster.pack_layers``) on ``state``'s layers."""
    import torch

    from img_env_tpu_torch.ops import raster

    lay = env._layers(state)
    h, w = lay.packed.shape
    count, ids = raster.robot_maps(lay.robot_cells, lay.robot_cells_valid,
                                   h, w)
    fn = lambda: raster.pack_layers(lay.obs_map, lay.ped_strong,
                                    lay.ped_weak, count, ids)
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"device_ops": len(dev) / reps,
            "device_ms": sum(e.time_range.elapsed_us() for e in dev)
            / 1e3 / reps}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    # chip_smoke (inputs, timer) from this repository; the package and its
    # kernel sources from the tree under test
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ablations: no CUDA device")
    from img_env_tpu_torch import EnvConfig, NavEnv
    from img_env_tpu_torch.ops import kernels, painter, pedmap, polar, raster

    kernels.library()
    tmp = os.path.join(kernels.BUILD_ROOT, "ablations")
    os.makedirs(tmp, exist_ok=True)
    builds, skipped = [], []
    names = list(ABLATIONS)
    if "block_sizes" not in painter.PainterTables._fields:
        names.remove("paint_block")
        skipped.append("paint_block: this tree's K5 takes other arguments")
    for name in names:
        cuts = ABLATIONS[name]
        with open(os.path.join(kernels.CSRC, f"{name}.cu")) as f:
            src = f.read()
        for cut, variants in cuts.items():
            cut_src = ablate(src, variants)
            if cut_src is None:
                skipped.append(f"{name}: {cut}")
                cs.log(f"# {name} {cut!r}: fits no variant of this tree")
                continue
            path = os.path.join(tmp, f"{name}_{len(builds)}.cu")
            with open(path, "w") as f:
                f.write(cut_src)
            builds.append((name, cut, path, path[:-3] + ".so"))
    kernels._run_all([[kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                       so, cu] for _, _, cu, so in builds])

    env = NavEnv(EnvConfig.from_dict(cs.BENCH200), "cuda")
    state, _ = env.reset()
    st, t = env.statics, env.tables
    poses = cs.crowded_poses(state.robots.pose)
    crowded = state._replace(robots=state.robots._replace(pose=poses))
    fargs = cs.fill_args(env, env._layers(crowded).packed, poses)
    occ = polar.fill_sorted_kernel(*fargs)
    s_hit, s_tail = cs.thresholds(env, occ)
    n, n_slots = poses.shape[0], st.polar.n_slots
    maps = fargs[0][None]
    h, w = fargs[0].shape
    bits = torch.empty((1, h, polar.bitmap_words(w)), dtype=torch.int32,
                       device="cuda")
    inv_res = float(np.float32(1.0) / np.float32(st.resolution))
    off, visits = t.painter.slots
    fill_out = torch.empty((n, n_slots), dtype=torch.bool, device="cuda")
    paint_out = torch.empty((n, st.painter.n_slots), dtype=torch.float32,
                            device="cuda")
    if "paint_block" in names:
        tb = painter.make_painter_tables(
            st.painter, painter.PaintBlocks.build(st.painter, s_hit.shape[1]),
            "cuda")
    cells = cs.raster_cases(env, state.robots.pose)[1][1]
    valid = t.robot_mask
    raster_out = torch.empty((h, w), dtype=torch.int32, device="cuda")

    env_p = NavEnv(EnvConfig.from_dict(cs.BENCH200PED), "cuda")
    state_p, _ = env_p.reset()
    hs, r_img = (int(env_p.cfg.ped_image_size[0]),
                 float(env_p.cfg.ped_image_r))
    res_p = 6.0 / hs
    base = cs.pedmap_cases(env_p, state_p)[1][1]
    ped_out = torch.empty((n, 3, hs, hs), dtype=torch.float32, device="cuda")

    def call(name, fn):
        stream = torch.cuda.current_stream().cuda_stream
        if name == "raster":
            return lambda: fn(cells.data_ptr(), valid.data_ptr(), n,
                              cells.shape[1], h, w, raster_out.data_ptr(),
                              stream)
        if name == "pedmap":
            return lambda: fn(*(x.data_ptr() for x in base), n,
                              base[0].shape[1], float(np.float32(res_p)),
                              float(np.float32(1.0) / np.float32(res_p)),
                              float(np.float32(r_img)), pedmap._r2(r_img),
                              pedmap.HALF, hs, ped_out.data_ptr(), stream)
        if name == "fill":
            return lambda: fn(maps.data_ptr(), bits.data_ptr(), 1, h, w,
                              *(x.data_ptr() for x in fargs[1:5]), n,
                              fargs[7], n_slots, inv_res, fargs[5].data_ptr(),
                              fargs[6].data_ptr(), fill_out.data_ptr(), stream)
        if name == "paint_block":
            return lambda: fn(s_hit.data_ptr(), s_tail.data_ptr(), n,
                              s_hit.shape[1],
                              *(x.data_ptr() for x in tb.blocks),
                              tb.blocks[0].shape[0], *tb.block_sizes,
                              paint_out.data_ptr(), st.painter.n_slots,
                              stream)
        return lambda: fn(s_hit.data_ptr(), s_tail.data_ptr(), n,
                          s_hit.shape[1], off.data_ptr(), visits.data_ptr(),
                          paint_out.data_ptr(), st.painter.n_slots, stream)

    runs = [(name, "kernel", getattr(kernels.library(),
                                     kernels._SIGNATURES[name][0]))
            for name in names]
    for name, cut, _, so in builds:
        fn = getattr(ctypes.CDLL(so), kernels._SIGNATURES[name][0])
        fn.argtypes = list(kernels._SIGNATURES[name][1])
        fn.restype = ctypes.c_int
        runs.append((name, cut, fn))
    times = {}
    for order in (runs, runs[::-1]):
        for name, cut, fn in order:
            run = call(name, fn)
            if run() != 0:
                sys.exit(f"kernel_ablations: {name} {cut!r} failed to launch")
            times.setdefault(f"{name}: {cut}", []).append(
                cs.cuda_ms(run, args.reps))
    wrappers = {
        "raster": lambda: raster.robot_maps_kernel(cells, valid, h, w),
        "pedmap": lambda: pedmap.ped_map_kernel(*base, res_p, r_img, hs)}
    wrapper_ms = {}
    for name, fn in list(wrappers.items()) * 2:
        wrapper_ms.setdefault(f"{name}: cuda_ms", []).append(
            cs.cuda_ms(fn, args.reps))
        wrapper_ms.setdefault(f"{name}: paced loop", []).append(
            paced_ms(fn, args.reps))
    parts = {"raster": device_parts(wrappers["raster"]),
             "fill": device_parts(lambda: polar.fill_sorted_kernel(*fargs))}
    out = {"card": cs.card_line(), "tree": args.tree, "ms": times,
           "wrapper_ms": wrapper_ms, "device_parts_ms": parts,
           "skipped": skipped}
    if hasattr(raster, "pack_layers"):
        out["pack_layers"] = pack_cost(env_p, state_p)
        cs.log(f"# packed-map composition at bench200ped: "
               f"{out['pack_layers']}")
    for k, v in list(times.items()) + list(wrapper_ms.items()):
        cs.log(f"# {k}: {', '.join(f'{x:.4f}' for x in v)} ms")
    for kernel, p in parts.items():
        for k, v in p.items():
            cs.log(f"# {kernel} device part {k[:40]}: {v:.4f} ms")
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
