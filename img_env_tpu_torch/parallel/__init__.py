"""Scene batching (torch port of ``img_env_tpu.parallel``)."""

from img_env_tpu_torch.parallel.batched_env import (  # noqa: F401
    BatchedNavEnv,
    rollout_with_obs,
)
