"""act_ms: host milliseconds of ``MpcController.act`` / ``.act_scenes`` per
control step, synchronised before and after."""


def read(ctx, suffix):
    spans = ctx["spans"].get("act", [])
    return sum(spans) / len(spans) if spans else None
