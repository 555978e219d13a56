"""Example drivers (ports of ``examples/``): ``python -m
img_env_tpu_torch.examples.run_random``, ``.run_mpc`` and ``.console``."""
