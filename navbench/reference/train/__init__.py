"""A frozen plain-torch copy of the one-process parts of
img_env_tpu_torch's PPO trainer (``ppo.py``) and of its clip and Adam
(``optim.py``): the training path's reference.  Imports nothing of the
program."""
