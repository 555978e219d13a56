"""device_ops_per_step: device operations (kernels, copies, sets) per
traced control step (torch.profiler)."""


def read(ctx, suffix):
    tr = ctx["trace"]
    return None if tr is None else tr["ops_per_step"]
