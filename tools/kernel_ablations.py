"""Where K2's and K3's time goes at bench200, on one NVIDIA GPU.

    python3 tools/kernel_ablations.py [--out FILE]

Builds the kernels of ``img_env_tpu_torch/csrc`` as they are and, from
the same sources with one part cut out (a text substitution each, checked
to apply), ablated copies that give wrong maps on purpose:

  * K3 ``no walks``: the slots a thread's first two visits leave undecided
    are never walked (the warp-cooperative walk's cost);
  * K3 ``no tests``: every slot is written 200 without a test (the store
    floor, with the prologue and the threshold staging);
  * K2 ``no map reads``: the packed map is never read, a set bit counts as
    occupied (the cost of the own-cell test's reads);
  * K2 ``stores only``: no slot arithmetic, the pre-pass and the bitmap
    staging kept (the cost of the per-slot arithmetic, as the difference).

Each runs on the inputs of chip_smoke.py's selfcheck (the bench200 reset
with every odd robot pushed onto its even neighbour) and is timed with
CUDA events, in turns: the kernel, the ablations, then again in reverse.
Also times the pre-pass and the fill of K2 apart with torch.profiler.
Prints one JSON line; with ``--out`` also writes it there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ABLATIONS = {
    "paint": {
        "no walks": ("        else if (lo[k] + 2 < lo[k + 1]) pend |= 1u << k;",
                     "        else if (false) pend |= 1u << k;"),
        "no tests": ("      if (lo[k] < lo[k + 1]) {\n"
                     "        float x = visit_value(first[k], th);",
                     "      if (false) {\n"
                     "        float x = visit_value(first[k], th);"),
    },
    "fill": {
        "no map reads": ("  const int v = set ? __ldg(map + (size_t)cm * w + cn) : 1;",
                         "  const int v = 1;"),
        "stores only": ("    if (j0 < n_fill) {", "    if (false) {"),
    },
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ablations: no CUDA device")
    import chip_smoke as cs
    from img_env_tpu_torch import EnvConfig, NavEnv
    from img_env_tpu_torch.ops import kernels, polar

    kernels.library()
    tmp = os.path.join(kernels.BUILD_ROOT, "ablations")
    os.makedirs(tmp, exist_ok=True)
    builds = []
    for name, cuts in ABLATIONS.items():
        src = open(os.path.join(kernels.CSRC, f"{name}.cu")).read()
        for cut, (old, new) in cuts.items():
            if src.count(old) != 1:
                sys.exit(f"kernel_ablations: {name} {cut!r} does not apply")
            path = os.path.join(tmp, f"{name}_{len(builds)}.cu")
            with open(path, "w") as f:
                f.write(src.replace(old, new))
            builds.append((name, cut, path, path[:-3] + ".so"))
    kernels._run_all([[kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                       so, cu] for _, _, cu, so in builds])

    env = NavEnv(EnvConfig.from_dict(cs.BENCH200))
    state, _ = env.reset()
    st, t = env.statics, env.tables
    poses = state.robots.pose.clone()
    poses[1::2, :2] = poses[0::2, :2] + 0.1
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

    def call(name, fn):
        stream = torch.cuda.current_stream().cuda_stream
        if name == "fill":
            return lambda: fn(maps.data_ptr(), bits.data_ptr(), 1, h, w,
                              *(x.data_ptr() for x in fargs[1:5]), n,
                              fargs[7], n_slots, inv_res, fargs[5].data_ptr(),
                              fargs[6].data_ptr(), fill_out.data_ptr(), stream)
        return lambda: fn(s_hit.data_ptr(), s_tail.data_ptr(), n,
                          s_hit.shape[1], off.data_ptr(), visits.data_ptr(),
                          paint_out.data_ptr(), st.painter.n_slots, stream)

    runs = [(name, "kernel", getattr(kernels.library(),
                                     kernels._SIGNATURES[name][0]))
            for name in ABLATIONS]
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
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            polar.fill_sorted_kernel(*fargs)
        torch.cuda.synchronize()
    parts = {e.key: e.device_time_total / e.count / 1e3
             for e in prof.key_averages() if e.device_time_total > 0}
    out = {"card": cs.card_line(), "ms": times, "fill_parts_ms": parts}
    for k, v in times.items():
        cs.log(f"# {k}: {', '.join(f'{x:.4f}' for x in v)} ms")
    for k, v in parts.items():
        cs.log(f"# K2 part {k[:40]}: {v:.4f} ms")
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
