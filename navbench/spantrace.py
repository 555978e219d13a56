"""The program's own spans (``img_env_tpu_torch.utils.trace``) against a
``torch.profiler`` trace: device operations, idle gaps and host syncs by
the layer that caused them, and host time by layer.

Every number here comes from three inputs on one clock (the system clock,
which ``time.time_ns`` and CUPTI share):

* the program's spans, ``(name, parent, start_ns, end_ns)`` as
  ``trace.drain()`` returns them (nested: a span lies inside its parent);
* the harness's labelled calls, ``(label, start_us, end_us)``
  (``Drive.labels`` in profile mode);
* the trace's events: device operations ``(name, start_us, end_us,
  correlation)`` and the runtime calls on the host ``(name, start_us,
  end_us, correlation)`` that issued them (``from_kineto``).

A device operation belongs to the innermost program span that holds the
host time of the runtime call with its correlation id; outside every
program span, to the harness label that holds it, else 'other'.  An
operation whose correlation id matches no runtime call is 'unattributed'.
Nothing is attributed by device timestamps.  An idle gap of the device
belongs to the innermost program span that holds its midpoint, else to the
harness label, as ``yardstick.reduce_trace`` gives it.

Standard library only (``yardstick`` for the gaps): the tests run it on
synthetic events.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from navbench import yardstick

# runtime calls that wait for the device (a plain cudaMemcpy blocks too)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
OTHER, UNATTRIBUTED = "other", "unattributed"


def from_kineto(events):
    """(device operations, runtime calls) of a profiler's kineto events:
    every device-side event (kernels, copies, sets), and every host-side
    event whose name starts with 'cu' (the CUDA runtime's calls and the
    lower-level cu* calls);
    the profiler's own host events (buffer requests, module loading) share
    correlation ids with those and are left out."""
    ops, calls = [], []
    for e in events:
        a = e.start_ns() / 1e3
        row = (e.name(), a, a + e.duration_ns() / 1e3, e.correlation_id())
        if str(e.device_type()).endswith("CUDA"):
            ops.append(row)
        elif e.name().startswith("cu"):
            calls.append(row)
    return ops, calls


class Owners:
    """Who was running on the host at a time (µs): the chain of program
    spans holding it, innermost first, or the harness label."""

    def __init__(self, spans, labels):
        order = sorted(range(len(spans)), key=lambda i: spans[i][2])
        self.spans = spans
        self.order = order
        self.starts = [spans[i][2] / 1e3 for i in order]
        self.labels = sorted(labels, key=lambda e: e[1])

    def chain(self, t_us: float):
        """Names of the program spans holding ``t_us``, innermost first
        (empty outside every span).  Spans nest, so the innermost one is
        the last to start before ``t_us`` or one of its ancestors."""
        k = bisect.bisect_right(self.starts, t_us) - 1
        i = self.order[k] if k >= 0 else -1
        while i >= 0 and self.spans[i][3] / 1e3 < t_us:
            i = self.spans[i][1]
        out = []
        while i >= 0:
            out.append(self.spans[i][0])
            i = self.spans[i][1]
        return out

    def label(self, t_us: float) -> str:
        held = [lab for lab, s, e in self.labels if s <= t_us <= e]
        return held[-1] if held else OTHER

    def owner(self, t_us: float) -> str:
        chain = self.chain(t_us)
        return chain[0] if chain else self.label(t_us)


def attribute(ops, calls, spans, labels) -> dict:
    """Device operations by layer.  Returns ``self`` {owner: ops} (the
    innermost span, or the harness label), ``within`` {span name:
    [(start_us, end_us, operation name)] of the operations issued anywhere
    inside a span of that name} and ``unattributed`` (operations with no
    matching runtime call)."""
    who = Owners(spans, labels)
    issued = {c: a for _, a, _, c in calls}
    own, within, lost = defaultdict(int), defaultdict(list), 0
    for name, a, b, corr in ops:
        t = issued.get(corr)
        if t is None:
            lost += 1
            own[UNATTRIBUTED] += 1
            continue
        chain = who.chain(t)
        own[chain[0] if chain else who.label(t)] += 1
        for span in set(chain):
            within[span].append((a, b, name))
    return {"self": own, "within": within, "unattributed": lost}


def syncs(calls, spans, labels) -> dict:
    """Runtime calls that wait for the device: ``inside`` {innermost
    program span: {call: count}} and ``outside`` {harness label: {call:
    count}} (the harness's own reads)."""
    who = Owners(spans, labels)
    out = {"inside": defaultdict(lambda: defaultdict(int)),
           "outside": defaultdict(lambda: defaultdict(int))}
    for name, a, _, _ in calls:
        if name in SYNC_CALLS:
            chain = who.chain(a)
            side, owner = (("inside", chain[0]) if chain
                           else ("outside", who.label(a)))
            out[side][owner][name] += 1
    return {side: {k: dict(v) for k, v in d.items()}
            for side, d in out.items()}


def idle_gaps(ops, spans, labels, lo_us: float, hi_us: float):
    """The device's idle seconds in [lo_us, hi_us] by the innermost
    program span holding each gap's midpoint, else the harness label,
    largest first."""
    who = Owners(spans, labels)
    busy = [(max(a, lo_us), min(b, hi_us)) for _, a, b, _ in ops
            if b > lo_us and a < hi_us]
    idle = defaultdict(float)
    for a, b in yardstick.gaps(busy, lo_us, hi_us):
        idle[who.owner(0.5 * (a + b))] += (b - a) / 1e6
    return sorted(idle.items(), key=lambda kv: -kv[1])


def host_table(spans, own, counts, steps: int) -> dict:
    """Host ms per step of each span name, its whole time and its self
    time (``own``: each span less its children, as the program's
    ``trace.self_ns`` gives it), calls per step, and the counters."""
    table = defaultdict(lambda: {"ms": 0.0, "self_ms": 0.0, "calls": 0.0})
    per = 1.0 / max(steps, 1)
    for (name, _, s, e), o in zip(spans, own):
        row = table[name]
        row["ms"] += (e - s) / 1e6 * per
        row["self_ms"] += o / 1e6 * per
        row["calls"] += per
    return {"spans": dict(table), "counts": dict(counts), "steps": steps}


def device_ms(rows, steps: int) -> float:
    """Device ms per step covered by the union of ``(start_us, end_us,
    name)`` rows."""
    return yardstick.union_s([(a, b) for a, b, _ in rows]) * 1e3 \
        / max(steps, 1)


def reduce(ops, calls, spans, labels, lo_us: float, hi_us: float,
           steps: int) -> dict:
    """The profiled steps' numbers by layer: device operations per step by
    owner (self) and by span name (within), device ms per step of each
    span name's operations (the union of their intervals) with its
    largest operations, idle gaps, host syncs, unattributed operations,
    and the sensor pass's device ms (``env.raster`` and ``env.sensor``)
    with the share of it in GEMM kernels."""
    inside = [o for o in ops if o[2] > lo_us and o[1] < hi_us]
    att = attribute(inside, calls, spans, labels)
    per = 1.0 / max(steps, 1)
    within = att["within"]
    top = {}
    for span, rows in within.items():
        by_name = defaultdict(float)
        for a, b, name in rows:
            by_name[yardstick.short(name, 64)] += (b - a) / 1e3 * per
        top[span] = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    sensor = within.get("env.raster", []) + within.get("env.sensor", [])
    sensor_ms = device_ms(sensor, steps)
    gemm_ms = device_ms([r for r in sensor if "gemm" in r[2].lower()],
                        steps)
    return {
        "steps": steps,
        "ops": len(inside),
        "unattributed": att["unattributed"],
        "ops_self": {k: v * per for k, v in att["self"].items()},
        "ops_within": {k: len(v) * per for k, v in within.items()},
        "device_ms_within": {k: device_ms(v, steps)
                             for k, v in within.items()},
        "top_ops_within": top,
        "idle_gaps": idle_gaps(inside, spans, labels, lo_us, hi_us),
        "syncs": syncs([c for c in calls if lo_us <= c[1] <= hi_us], spans,
                       labels),
        "sensor_ms": sensor_ms if sensor else None,
        "sensor_gemm_share": gemm_ms / sensor_ms if sensor_ms else None,
    }


def metrics(host, device, batch: bool) -> dict:
    """The per-layer numbers the spans give, under the names a benchmark
    entry would take (``.batch`` for a scene batch, ``.control`` for one
    scene); a number with nothing to read is left out.  ``host``:
    ``host_table`` of the span phase; ``device``: ``reduce`` of the
    profiled steps (either may be None)."""
    sfx = ".batch" if batch else ".control"
    out = {}
    spans = (host or {}).get("spans", {})
    if "env.crowd" in spans:
        out["crowd_ms" + sfx] = spans["env.crowd"]["ms"]
    resets = (host or {}).get("counts", {}).get("reset.scenes", 0)
    if resets and "batch.reset_local" in spans:
        out["reset_ms" + sfx] = (spans["batch.reset_local"]["ms"]
                                 * host["steps"] / resets)
    if device:
        within = device["ops_within"]
        for key, span in (("crowd_ops_per_step", "env.crowd"),
                          ("act_ops_per_step", "mpc.act")):
            if span in within:
                out[key + sfx] = within[span]
        if device["sensor_ms"] is not None:
            out["sensor_device_ms" + sfx] = device["sensor_ms"]
        if within:
            out["host_syncs_per_step" + sfx] = sum(
                n for calls in device["syncs"]["inside"].values()
                for n in calls.values()) / device["steps"]
    return out
