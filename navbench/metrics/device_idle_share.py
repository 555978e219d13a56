"""device_idle_share: 1 - the union of the device's operation intervals
over the traced steps' wall time, in percent (torch.profiler)."""


def read(ctx, suffix):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
