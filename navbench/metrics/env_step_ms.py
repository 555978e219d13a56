"""env_step_ms: host milliseconds of the env step (``NavEnv.step`` or
``BatchedNavEnv.step``) per control step, synchronised before and after;
for a batch the autoreset's ``reset_local`` time is added, spread over the
steps.  Read from the traced run's first half."""


def read(ctx, suffix):
    steps = ctx["spans"].get("env_step", [])
    if not steps:
        return None
    total = sum(steps) + sum(ctx["spans"].get("reset_local", []))
    return total / len(steps)
