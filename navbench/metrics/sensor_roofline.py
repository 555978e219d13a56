"""sensor_roofline: the least time of one step's K1-K3 work (bytes and
operations from the cell's shapes, ``yardstick.sensor_counts``, at the
H100's 3.35 TB/s and 67 TFLOP/s) over the device time the trace gives
those kernels per step, in percent."""

from navbench import yardstick


def read(ctx, suffix):
    tr, ref = ctx["trace"], ctx["reference"]
    if tr is None or getattr(ref, "env", None) is None:
        return None
    counts = yardstick.sensor_counts(ref.env, ctx["scenes"])
    device_s = sum(tr["sensor_s"].values()) / tr["steps"]
    if device_s <= 0:
        return None
    least = sum(yardstick.least_s(b, o) for b, o in counts.values())
    return 100.0 * least / device_s
