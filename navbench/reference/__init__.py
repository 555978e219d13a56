"""A frozen copy of img_env_tpu_torch's plain-torch step path, the
correctness check's reference: each hand kernel replaced by its plain twin,
no import of the program."""
