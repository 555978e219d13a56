"""update_mfu: the PPO update's floating-point operations
(``trainflops.update_flops``, from the reference policy's layer shapes and
the traffic) over its host time (``update_ms``) at the H100's float32 peak
outside the tensor cores (67 TFLOP/s: the configuration runs with TF32
off), in percent."""

from navbench import yardstick


def read(ctx, suffix):
    spans = ctx["spans"].get("update", [])
    flops = getattr(ctx["reference"], "update_flops", None)
    if not spans or flops is None:
        return None
    seconds = sum(spans) / len(spans) / 1e3
    return 100.0 * flops() / (seconds * yardstick.FLAT_OPS_PER_S)
