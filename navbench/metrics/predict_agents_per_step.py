"""predict_agents_per_step: agent-steps a control step that the MPC's
crowd prediction head rolled forward (the program's ``predict.agents``
counter: +M a crowd-model step, H·M an act over M peds; 0 where the head
predicts by constant velocity), over the traced run's first half, where
the loop keeps the counts (``loops/beep_control.py``)."""


def read(ctx, suffix):
    drive = getattr(ctx["reference"], "drive", None)
    counts = getattr(drive, "counts", {}).get("predict.agents", [])
    return sum(counts) / len(counts) if counts else None
