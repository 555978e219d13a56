"""update_ms: host milliseconds a PPO update of the update proper (the last
value, GAE, epochs x minibatches of forward, backward, clip and Adam),
as the trainer's own ``timings`` give them (``train_step(timings=)``,
which synchronises the device at each phase's boundary); read from the
traced run's first half."""


def read(ctx, suffix):
    spans = ctx["spans"].get("update", [])
    return sum(spans) / len(spans) if spans else None
