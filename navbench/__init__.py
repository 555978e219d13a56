"""navbench: the benchmark of img_env_tpu_torch (see README.md)."""
