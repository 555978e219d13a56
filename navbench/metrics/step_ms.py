"""step_ms: the window's wall time over the control steps it completed; the
window ends after the last step's host reads."""


def read(ctx, suffix):
    win = ctx["window"]
    return win["window_s"] / len(win["step_s"]) * 1e3
