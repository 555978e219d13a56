"""policy_ms: host milliseconds of the policy call (``mean_action_fn``) per
control step, synchronised before and after."""


def read(ctx, suffix):
    spans = ctx["spans"].get("policy", [])
    return sum(spans) / len(spans) if spans else None
