"""PPO training over the scene batch (torch port of
``img_env_tpu.train``)."""

from img_env_tpu_torch.train.ppo import (PpoConfig, TrainState,
                                         make_train_step, obs_features)

__all__ = ["PpoConfig", "TrainState", "make_train_step", "obs_features"]
