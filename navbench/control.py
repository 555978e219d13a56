"""The correctness check's readings: for each seed, the program drives a
cell's traffic for as many steps as a run compares, and the frozen
reference replays the compared steps in float32 (the sound reading) and
in each control precision ('tf32', 'bf16').  One JSON line per seed and
precision; the limits in ``navbench/checks/<cell>.json`` are set between
the largest sound reading and the smallest control reading.

    python -m navbench.control --workload stage5.eval50 --seeds 1,2,3 \
        --controls tf32,bf16

Not part of a benchmark run: it sets the limits, and the tests under
``navbench/tests`` hold a control to failing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from navbench import run


def readings(bench: dict, workload: str, seed: int, controls, device: str,
             root: str = run.ROOT, sut=None) -> dict:
    """{precision: {number: reading}} for one seed: the program's compared
    steps (index 0 .. the traffic's ``check.within``) replayed by the
    reference in float32 ('float32') and in each control precision."""
    dr = run.make_drive(bench, workload, seed, device, root, sut)
    dr.setup()
    dr.warm_up()
    for _ in range(int(dr.traffic["check"]["within"])):
        dr.step()
    dr.finish()
    dr.free()
    out = {}
    for c in [None, *controls]:
        out[c or "float32"] = dr.reference(c).run()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m navbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", default="tf32,bf16")
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("navbench.control: no CUDA card", file=sys.stderr)
        return 2
    run.set_caches(run.ROOT)
    bench = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
    controls = [c for c in a.controls.split(",") if c]
    for seed in (int(s) for s in a.seeds.split(",")):
        for prec, vals in readings(bench, a.workload, seed, controls,
                                   "cuda").items():
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "precision": prec, "readings": vals}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
