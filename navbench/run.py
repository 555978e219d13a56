"""navbench: one run of one cell of the benchmark of ``img_env_tpu_torch``.

    python -m navbench.run --workload bench200.mppi --seed 7 --seconds 10 \
        --trace 0

Reads ``BENCHMARK.json`` at the root of the checkout, finds the cell's
configuration (``navbench/configs/<config>.json``), traffic
(``navbench/traffic/<traffic>.json``, whose ``loop`` and ``actor`` name
``navbench/loops/<loop>.py`` and ``navbench/actors/<actor>.py``),
correctness limits (``navbench/checks/<cell>.json``) and metric readers
(``navbench/metrics/<metric>.py``, or ``<name before the first dot>.py``
for a split metric) by name, then loads, warms up, measures for
``--seconds`` and prints one JSON line as its last line of output.  The
card's SM clock and power draw are sampled beside the window and printed
on standard error.

``--trace 0`` reports the cell's end-to-end metrics over a plain window.
``--trace 1`` reports its per-layer metrics: the window's first half times
each call into the program on the host clock between synchronisations,
then the profiler traces ``trace_steps`` steps.  Both runs replay the
compared steps through the frozen plain reference once the window has
closed and its memory peak has been read, and report ``correct``.

The run fails, and prints no result, without a CUDA card (or with fewer
than the cell asks for), without the program, and when ``jax``,
``jaxlib``, ``flax`` or ``img_env_tpu`` is loaded once the window has
closed.
"""

from __future__ import annotations

import time

T_MODULE = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from navbench.parts import RunError, load_part  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "navbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "img_env_tpu")
TOP = 10        # entries of each breakdown list


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module
    was imported."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime", encoding="ascii") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_MODULE


def load_json(path: str):
    if not os.path.exists(path):
        raise RunError(f"missing {os.path.relpath(path, ROOT)}")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_config(root: str, entry: dict) -> dict:
    """A configuration file, its policy file's path made absolute and its
    bytes held to the ``policy_sha256`` the file pins."""
    config = load_json(os.path.join(root, entry["file"]))
    if config.get("policy"):
        config["policy"] = os.path.join(root, config["policy"])
        if not os.path.exists(config["policy"]):
            raise RunError(f"missing {os.path.relpath(config['policy'], root)}")
        with open(config["policy"], "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != config.get("policy_sha256"):
            raise RunError(f"{entry['file']}: the policy file's sha256 is "
                           f"{digest}, the configuration pins "
                           f"{config.get('policy_sha256')}")
    return config


def find_cell(bench: dict, name: str):
    """(workload, config entry, end-to-end metrics, per-layer metrics) of
    the cell ``name``: the metrics whose ``workloads`` name it, or that
    name none."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    mine = lambda ms: [m for m in ms if name in m.get("workloads", [name])]
    return (w, configs[w["config"]], mine(bench["end_to_end"]),
            mine(bench["per_layer"]))


def reader(name: str, root: str = HERE):
    """The reader of metric ``name``: ``metrics/<name>.py``, or for a split
    metric (``base.suffix``) ``metrics/<base>.py``; returns
    ``read(ctx, suffix)``."""
    base, _, suffix = name.partition(".")
    for fname, sfx in ((name, ""), (base, suffix)):
        if os.path.exists(os.path.join(root, "metrics", fname + ".py")):
            mod = load_part(root, "metrics", fname)
            return lambda ctx, m=mod, s=sfx: m.read(ctx, s)
    raise RunError(f"no reader for metric {name!r} under navbench/metrics")


def set_caches(root: str) -> None:
    """Every build and table cache of the program inside the checkout, at
    fixed paths."""
    cache = os.path.join(root, "navbench", ".cache")
    os.environ.setdefault("IMG_ENV_TPU_STATICS_CACHE",
                          os.path.join(cache, "statics"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def program():
    """The system under test: the names the harness drives (a loop or
    actor that needs more imports it; tests hand in a program with a fault
    planted)."""
    import img_env_tpu_torch as sut
    from img_env_tpu_torch.env.sampler import ScenarioSample

    ns = type("Program", (), {})()
    for name in ("EnvConfig", "NavEnv", "BatchedNavEnv", "MpcController",
                 "MppiConfig", "load_policy_npz", "mean_action_fn"):
        setattr(ns, name, getattr(sut, name))
    ns.ScenarioSample = ScenarioSample
    return ns


def make_drive(bench: dict, workload: str, seed: int, device: str,
               root: str = ROOT, sut=None):
    """The cell's loop (``navbench/loops/<loop>.py``), not yet set up."""
    from navbench import check

    here = os.path.join(root, "navbench")
    w, cfg_entry, _, _ = find_cell(bench, workload)
    config = load_config(root, cfg_entry)
    traffic = load_json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    loop = load_part(here, "loops", traffic["loop"]).Loop
    return loop(sut if sut is not None else program(),
                check.load_reference(), config, traffic, seed, device, here)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or "not read"


class CardSamples:
    """The card's SM clock (MHz), power draw (W) and utilisation (%),
    sampled by ``nvidia-smi`` every ``ms`` milliseconds between ``start``
    and ``stop``; nothing where nvidia-smi is absent."""

    def __init__(self, ms: int = 500):
        self.ms, self.proc, self.rows = ms, None, []

    def start(self, dev) -> None:
        if dev.type != "cuda":
            return
        vis = os.environ.get("CUDA_VISIBLE_DEVICES", "")
        idx = vis.split(",")[dev.index or 0] if vis else str(dev.index or 0)
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--id={idx.strip()}",
                 "--query-gpu=clocks.sm,power.draw,utilization.gpu",
                 "--format=csv,noheader,nounits", f"--loop-ms={self.ms}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self) -> None:
        if self.proc is None:
            return
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        self.proc = None
        for line in out.splitlines():
            try:
                self.rows.append([float(x) for x in line.split(",")])
            except ValueError:
                pass

    def lines(self):
        if not self.rows:
            yield "# card during the window: not sampled"
            return
        cols = list(zip(*self.rows))
        for name, unit, vals in (("sm clock", "MHz", cols[0]),
                                 ("power draw", "W", cols[1]),
                                 ("utilisation", "%", cols[2])):
            yield (f"# card during the window, {name} ({unit}, "
                   f"{len(vals)} samples): min {min(vals)} median "
                   f"{statistics.median(vals)} max {max(vals)} mean "
                   f"{statistics.fmean(vals)}")


def profile_steps(drive, steps: int, log):
    """``steps`` steps under torch.profiler, recording the device's
    activity only (CUPTI), so that the host's pace stays near the plain
    window's; the harness's calls are timed on the system clock, which the
    profiler's timestamps share.  Returns the trace reduced by
    ``yardstick.reduce_trace``, or None without a card."""
    import torch
    from navbench import yardstick

    if drive.dev.type != "cuda":
        return None
    drive.mode = "profile"
    drive.labels.clear()
    drive._sync()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        lo = time.time_ns() / 1e3
        for _ in range(steps):
            drive.step()
        drive._sync()
        hi = time.time_ns() / 1e3
    drive.mode = "plain"
    dev_events = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            a = e.start_ns() / 1e3
            dev_events.append((e.name(), a, a + e.duration_ns() / 1e3))
    if not dev_events:
        return None
    inside = sum(lo <= a and b <= hi for _, a, b in dev_events)
    log.append(f"# traced device operations inside the window: {inside} of "
               f"{len(dev_events)}; window {(hi - lo) / 1e6:.6f} s over "
               f"{steps} steps")
    return yardstick.reduce_trace(dev_events, drive.labels, lo, hi, steps)


def measure(drive, seconds: float, trace: bool, log) -> dict:
    """The window.  Without trace: steps until ``seconds`` have passed,
    each timed from its start to the end of its host reads; the window
    ends on a synchronisation after the last.  With trace: the first half
    with every call synchronised and timed, then ``trace_steps`` profiled
    steps."""
    drive._sync()
    win = {"step_s": []}
    if not trace:
        t0 = time.perf_counter()
        drive.open_window(t0, seconds)
        while True:
            a = time.perf_counter()
            drive.step()
            b = time.perf_counter()
            win["step_s"].append(b - a)
            if b - t0 >= seconds:
                break
        drive._sync()
        win["window_s"] = time.perf_counter() - t0
        return win
    drive.mode = "spans"
    t0 = time.perf_counter()
    drive.open_window(t0, seconds / 2)
    while time.perf_counter() - t0 < seconds / 2 or not win["step_s"]:
        a = time.perf_counter()
        drive.step()
        win["step_s"].append(time.perf_counter() - a)
    drive.mode = "plain"
    win["window_s"] = time.perf_counter() - t0
    win["trace"] = profile_steps(drive, int(drive.traffic["trace_steps"]),
                                 log)
    return win


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", root: str = ROOT,
             sut=None, log=None) -> dict:
    """One run of ``workload``; returns the result line's object (and, in
    ``log``, the lines for standard error).  ``sut``: the program's
    names (default: the program)."""
    import torch
    from navbench import check

    here = os.path.join(root, "navbench")
    log = log if log is not None else []
    _, _, e2e, per_layer = find_cell(bench, workload)
    limits = check.load_limits(os.path.join(here, "checks",
                                            workload + ".json"))
    metrics = e2e if not trace else per_layer
    readers = {m["name"]: reader(m["name"], here) for m in metrics}
    dr = make_drive(bench, workload, seed, device, root, sut)
    dr.setup()
    dr.warm_up()
    # what set-up left is kept out of the collector's passes in the window
    gc.collect()
    gc.freeze()
    # the harness's own input draw is not the program's set-up
    setup_s = process_age_s() - dr.harness_s
    card = CardSamples()
    card.start(dr.dev)
    try:
        win = measure(dr, seconds, trace, log)
    finally:
        card.stop()
    dr.finish()
    dr._sync()
    cuda = dr.dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dr.dev) if cuda else 0
    steps = len(win["step_s"])
    dr.free()
    if cuda:
        torch.cuda.empty_cache()
    replay = dr.reference()
    values = replay.run()
    correct, rows = check.judge(values, limits)

    ctx = {"setup_s": setup_s, "window": win, "steps": steps,
           "robots": dr.robots * dr.scenes, "scenes": dr.scenes,
           "spans": dr.spans, "trace": win.get("trace"),
           "reference": replay}
    out = {}
    for m in metrics:
        v = readers[m["name"]](ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dr.dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": steps, "failed": 0,
              "metrics": out, "device": dev_info}
    tr = win.get("trace")
    if trace and tr is not None:
        dev_info["busy_s"] = tr["busy_s"]
        dev_info["window_s"] = tr["window_s"]
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in tr["device_ops"][:TOP]],
            "idle_gaps": [[n, s] for n, s in tr["idle_gaps"][:TOP]]}
    log.append(f"# steps in the window: {steps} (the sample of step_ms_p95)")
    log.append(f"# harness's episode draw, left out of setup_s: "
               f"{dr.harness_s} s")
    log.extend(card.lines())
    log.append(f"# compared steps: {[r['k'] for r in dr.checks]}")
    log.extend(dr.log_lines())
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    log.extend(f"check {n} {v!r} limit {lim!r}" for n, v, lim in rows)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m navbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
        w = find_cell(bench, a.workload)[0]
        import torch

        if not torch.cuda.is_available():
            raise RunError("no CUDA card: this benchmark measures the card "
                           "and does not fall back to the CPU")
        if torch.cuda.device_count() < int(w["chips"]):
            raise RunError(f"{a.workload} asks for {w['chips']} cards, "
                           f"{torch.cuda.device_count()} present")
        set_caches(ROOT)
        # one host thread: the harness and the program's host work are
        # launch-bound, and a pool of threads only adds noise
        torch.set_num_threads(1)
        print(f"# card: {card_line()}", file=sys.stderr, flush=True)
        log = []
        result = run_cell(bench, a.workload, a.seed, a.seconds,
                          bool(a.trace), "cuda", ROOT, log=log)
        found = forbidden_modules()
        if found:
            raise RunError(f"loaded once the window closed: "
                           f"{', '.join(found)}")
    except (RunError, ImportError) as e:
        print(f"navbench: {e}", file=sys.stderr, flush=True)
        return 2
    for line in log:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
