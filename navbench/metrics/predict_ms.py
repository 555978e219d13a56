"""predict_ms: host milliseconds a control step inside the program's
``mpc.predict`` span (the MPC's crowd prediction), the program's tracing
on around the act; read from the traced run's first half, where the loop
files them (``loops/beep_control.py``)."""


def read(ctx, suffix):
    spans = ctx["spans"].get("predict", [])
    return sum(spans) / len(spans) if spans else None
