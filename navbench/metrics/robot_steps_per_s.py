"""robot_steps_per_s: robots x batch steps completed in the window, over
the window's wall time."""


def read(ctx, suffix):
    win = ctx["window"]
    return ctx["robots"] * len(win["step_s"]) / win["window_s"]
