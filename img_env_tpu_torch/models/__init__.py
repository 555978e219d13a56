"""Policy / value networks for the crowd-navigation tasks."""

from img_env_tpu_torch.models.policy import (
    CrowdNavPolicy,
    PolicyConfig,
    example_inputs,
    init_policy,
    load_ckpt_policy,
    load_policy_npz,
    mean_action_fn,
    policy_params_from_numpy,
    sample_action,
)

__all__ = [
    "CrowdNavPolicy",
    "PolicyConfig",
    "example_inputs",
    "init_policy",
    "load_ckpt_policy",
    "load_policy_npz",
    "mean_action_fn",
    "policy_params_from_numpy",
    "sample_action",
]
