"""Evaluation, recording and replay (no rendering: ``eval/render.py``,
``plots.py`` and ``live_view.py`` are not ported)."""

from img_env_tpu_torch.eval.batched_eval import evaluate_batched
from img_env_tpu_torch.eval.recorder import (EpisodeRecord, EpisodeRecorder,
                                             ScenarioBank, load_state,
                                             save_state)

__all__ = [
    "EpisodeRecord",
    "EpisodeRecorder",
    "ScenarioBank",
    "evaluate_batched",
    "load_state",
    "save_state",
]
