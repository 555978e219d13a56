"""img_env_tpu_torch — the crowd-navigation simulator and MPC engine of
``img_env_tpu`` in PyTorch, with its TPU kernels rewritten in CUDA C++ for
NVIDIA Hopper (``csrc/``).

Importing the package loads no JAX, no OpenCV, PIL or yaml, and builds no
kernel: kernels compile on first use from a CUDA tensor.
"""

from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.env.gymapi import make_env
from img_env_tpu_torch.env.nav_env import NavEnv
from img_env_tpu_torch.eval.batched_eval import evaluate_batched
from img_env_tpu_torch.eval.recorder import ScenarioBank
from img_env_tpu_torch.models.policy import load_policy_npz, mean_action_fn
from img_env_tpu_torch.mpc.controller import MpcController
from img_env_tpu_torch.mpc.mppi import MppiConfig
from img_env_tpu_torch.parallel import BatchedNavEnv

__all__ = ["EnvConfig", "NavEnv", "BatchedNavEnv", "MpcController",
           "MppiConfig", "make_env", "evaluate_batched", "ScenarioBank",
           "load_policy_npz", "mean_action_fn"]
