"""The yardstick: the card's published peaks, the least time of a piece of
work, the bytes and operations of the sensor kernels computed from a
cell's shapes, and the reduction of a ``torch.profiler`` trace to device
busy time, operation counts and idle gaps.

Nothing here imports the program under test: the kernel counts read the
shapes of the frozen reference (``navbench/reference``), which builds its
own tables from the configuration.
"""

from __future__ import annotations

from collections import defaultdict

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FLAT_OPS_PER_S = 67e12      # float32 outside the tensor cores, taken for the
                            # kernels' integer work as well

# device kernel names of the sensor pass (the program's csrc/*.cu): K1 is a
# clear kernel and the raster kernel, K2 a bitmap pre-pass and the fill,
# K3 the slot painter
SENSOR_KERNELS = {
    "K1": ("clear_map_kernel", "raster_robots_kernel"),
    "K2": ("occupancy_bits_kernel", "fill_bits_kernel"),
    "K3": ("paint_slots_kernel",),
}


def least_s(nbytes: float, ops: float) -> float:
    """The least time for ``nbytes`` moved (each input read once, each
    output written once) and ``ops`` operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FLAT_OPS_PER_S)


def sensor_counts(ref_env, scenes: int) -> dict:
    """{kernel: (bytes, operations)} of one sensor pass over ``scenes``
    scenes of the reference env ``ref_env`` (one sensor group, the slot
    painter), as chip_smoke's kernel bounds count them:

    * K1: the robots' footprint cells (int32 pairs) and their mask read,
      the packed map (int32) written; 4 operations a footprint cell;
    * K2: the packed maps and the gated slots' coordinates read, four
      float32 pose terms a robot, one bool a slot and robot written; 10
      operations a gated slot and robot, 2 a map cell;
    * K3: the two int16 thresholds a beam and robot and the slot layout
      (offsets and visit lists) read, one float32 a slot and robot
      written; one operation an output.  K3's visit tests depend on the
      thresholds; at bench200 they are ~98 M operations against ~143 MB,
      a bound by operations 1/29 of the one by bytes, so they are left
      out of the count."""
    t = ref_env.tables
    h, w = ref_env.static_map.shape
    n = scenes * int(t.robot_mask.shape[0])
    pts = int(t.robot_mask.shape[1])
    k1_bytes = n * pts * (2 * 4) + t.robot_mask.numel() + scenes * h * w * 4
    k1_ops = 4 * n * pts
    pol = t.polar
    nf = int(ref_env.statics.sensor_groups[0].polar.n_fill_slots)
    n_slots = int(pol.pix_x.shape[0])
    xy_bytes = nf * (pol.pix_x.element_size() + pol.pix_y.element_size())
    k2_bytes = scenes * h * w * 4 + xy_bytes + 4 * 4 * n + n * n_slots
    k2_ops = 10 * n * nf + 2 * scenes * h * w
    off, visits = t.painter.slots
    beams = int(ref_env.statics.view_params.range_total)
    out = n * int(ref_env.statics.sensor_groups[0].painter.n_slots)
    k3_bytes = (2 * 2 * n * beams + off.numel() * off.element_size()
                + visits.numel() * visits.element_size() + 4 * out)
    return {"K1": (k1_bytes, k1_ops), "K2": (k2_bytes, k2_ops),
            "K3": (k3_bytes, out)}


def short(name: str, width: int = 160) -> str:
    """A device operation's name without its return type and namespaces,
    cut to ``width`` characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "at::", "std::"):
        name = name.replace(noise, "")
    return name if len(name) <= width else name[:width - 3] + "..."


def union_s(intervals) -> float:
    """Seconds covered by the union of (start_us, end_us) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6


def gaps(intervals, lo: float, hi: float):
    """The idle (start_us, end_us) gaps of the device between ``lo`` and
    ``hi`` outside the union of ``intervals``."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def reduce_trace(device_events, label_events, lo_us: float, hi_us: float,
                 steps: int) -> dict:
    """The traced window's device numbers.  ``device_events``: (name,
    start_us, end_us) of every device operation (kernels, copies, sets);
    ``label_events``: (label, start_us, end_us) of the harness's own calls
    on the host; [lo_us, hi_us] the window.  Returns busy_s, window_s,
    ops_per_step, the time of each device operation by name, the idle
    seconds by the label the host was in, and the sensor kernels' device
    seconds."""
    inside = [(n, max(a, lo_us), min(b, hi_us)) for n, a, b in device_events
              if b > lo_us and a < hi_us]
    spans = [(a, b) for _, a, b in inside]
    by_name = defaultdict(float)
    for name, a, b in inside:
        by_name[name] += (b - a) / 1e6
    idle = defaultdict(float)
    labels = sorted(label_events, key=lambda e: e[1])
    for a, b in gaps(spans, lo_us, hi_us):
        mid = 0.5 * (a + b)
        # the innermost (latest-starting) label that holds the midpoint
        held = [lab for lab, s, e in labels if s <= mid <= e]
        idle[held[-1] if held else "other"] += (b - a) / 1e6
    sensor = {k: sum(s for name, s in by_name.items()
                     if any(n in name for n in names))
              for k, names in SENSOR_KERNELS.items()}
    return {
        "busy_s": union_s(spans),
        "window_s": (hi_us - lo_us) / 1e6,
        "ops_per_step": len(inside) / max(steps, 1),
        "device_ops": sorted(((short(n), s) for n, s in by_name.items()),
                             key=lambda kv: -kv[1]),
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1]),
        "sensor_s": sensor,
        "steps": steps,
    }
