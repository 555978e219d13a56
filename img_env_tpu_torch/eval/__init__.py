"""Evaluation, recording, replay and rendering."""

from img_env_tpu_torch.eval.batched_eval import evaluate_batched
from img_env_tpu_torch.eval.recorder import (EpisodeRecord, EpisodeRecorder,
                                             ScenarioBank, load_state,
                                             save_state)
from img_env_tpu_torch.eval.render import (KELLY_COLORS, render_frame,
                                           render_tiles)

__all__ = [
    "EpisodeRecord",
    "EpisodeRecorder",
    "ScenarioBank",
    "KELLY_COLORS",
    "evaluate_batched",
    "load_state",
    "render_frame",
    "render_tiles",
    "save_state",
]
