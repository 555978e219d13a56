"""autoreset_ms: host milliseconds a PPO update of its autoreset (the
finished scenes found and redrawn), as the trainer's own ``timings``
give them (``train_step(timings=)``, which synchronises the device at
each phase's boundary); read from the traced run's first half."""


def read(ctx, suffix):
    spans = ctx["spans"].get("autoreset", [])
    return sum(spans) / len(spans) if spans else None
