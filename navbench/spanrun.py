"""One cell driven with the program's own spans on: host time, device
operations, idle gaps and host syncs by the program's layers.

    python -m navbench.spanrun --workload stage5.eval50 --seed 7 \
        --seconds 20 [--out FILE]

Not part of a benchmark run (``run.py`` does not call it): it builds the
cell as ``run.py`` does and then, with ``img_env_tpu_torch.utils.trace``
switched on,

1. set-up: the statics' seconds (``setup.statics``) beside the harness's
   episode draw;
2. the span phase: ``--seconds`` of steps, each harness call synchronised
   as in a ``--trace 1`` run's first half; the program's spans reduced to
   host ms a step by span name, whole and self (``spantrace.host_table``),
   and its counters;
3. ``trace_steps`` profiled steps (torch.profiler, device activity only,
   which also records the runtime calls): device operations, device ms,
   idle gaps and host syncs by the program span that issued them
   (``spantrace.reduce``), beside the harness-label reduction
   (``yardstick.reduce_trace``) of the same events.

It prints one JSON line (also written to ``--out``), the numbers
``spantrace.metrics`` names among them, and on standard error the count of
device operations that match no runtime call.  No correctness check: the
program's outputs are those of a plain run (tests/test_torch_trace.py).
Phases 2 and 3 repeat ``run.measure``'s span half and ``run.profile_steps``:
once ``run.py`` reads the program's spans in ``--trace 1`` runs, this
module goes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from navbench import run, spantrace, yardstick
from navbench.parts import RunError


def span_phase(drive, trace, seconds: float) -> dict:
    """``seconds`` of steps with each harness call synchronised (mode
    'spans') and the program's spans on; their host table."""
    drive.mode = "spans"
    drive.spans.clear()
    trace.drain()
    trace.enable()
    t0 = time.perf_counter()
    drive.open_window(t0, seconds)
    steps = 0
    while time.perf_counter() - t0 < seconds or not steps:
        drive.step()
        steps += 1
    trace.disable()
    drive.mode = "plain"
    spans, counts = trace.drain()
    table = spantrace.host_table(spans, trace.self_ns(spans), counts, steps)
    table["harness_ms"] = {k: sum(v) / steps for k, v in drive.spans.items()}
    return table


def profile_phase(drive, trace, steps: int, log) -> dict:
    """``steps`` profiled steps with the program's spans on; the events by
    program span and by harness label."""
    import torch

    drive.mode = "profile"
    drive.labels.clear()
    drive._sync()
    trace.drain()
    trace.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        lo = time.time_ns() / 1e3
        for _ in range(steps):
            drive.step()
        drive._sync()
        hi = time.time_ns() / 1e3
    trace.disable()
    drive.mode = "plain"
    spans, _ = trace.drain()
    ops, calls = spantrace.from_kineto(prof.profiler.kineto_results.events())
    out = spantrace.reduce(ops, calls, spans, drive.labels, lo, hi, steps)
    out["runtime_calls"] = len(calls)
    base = yardstick.reduce_trace([o[:3] for o in ops], drive.labels, lo, hi,
                                  steps)
    out["harness"] = {k: base[k] for k in ("busy_s", "window_s",
                                           "ops_per_step", "idle_gaps")}
    log.append(f"# device operations with no matching runtime call: "
               f"{out['unattributed']} of {out['ops']} "
               f"({len(calls)} runtime calls traced)")
    return out


def run_spans(bench: dict, workload: str, seed: int, seconds: float,
              device: str = "cuda", root: str = run.ROOT, log=None) -> dict:
    """One cell with the program's spans on (module docstring); on the
    CPU (tests) the profiled steps are left out."""
    from img_env_tpu_torch.utils import trace

    log = log if log is not None else []
    dr = run.make_drive(bench, workload, seed, device, root)
    trace.enable()
    dr.setup()
    trace.disable()
    setup_spans, _ = trace.drain()
    dr.warm_up()
    res = {"workload": workload, "seed": seed, "card": run.card_line(),
           "setup_statics_s": sum(e - s for n, _, s, e in setup_spans
                                  if n == "setup.statics") / 1e9,
           "harness_draw_s": dr.harness_s}
    res["host"] = span_phase(dr, trace, seconds)
    res["device"] = (profile_phase(dr, trace,
                                   int(dr.traffic["trace_steps"]), log)
                     if dr.dev.type == "cuda" else None)
    res["metrics"] = spantrace.metrics(res["host"], res["device"], dr.batch)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m navbench.spanrun")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    a = p.parse_args(argv)
    log = []
    try:
        import torch

        if not torch.cuda.is_available():
            raise RunError("no CUDA card")
        run.set_caches(run.ROOT)
        torch.set_num_threads(1)
        bench = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
        res = run_spans(bench, a.workload, a.seed, a.seconds, log=log)
    except (RunError, ImportError) as e:
        print(f"navbench.spanrun: {e}", file=sys.stderr, flush=True)
        return 2
    for line in log:
        print(line, file=sys.stderr)
    line = json.dumps(res)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
