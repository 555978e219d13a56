"""One whole PPO ``train_step`` of the port against the JAX package's on
a crowd config (tests/test_multiscene_flat.py's: 2 scenes of 2 robots, 3
rectangles and 2 SFM leg peds, 3 m views, 64 beams), the JAX draws
injected, ``tx = clip_by_global_norm + sgd``; the machinery and the easy
config are in tests/test_torch_ppo.py (this file compiles its own JAX train
step, ~45 s, so the two run on separate workers).

The peds start each episode from rest, where the SFM's angular term is
ill-conditioned (F15): the port's and XLA's peds drift apart by ~1e-5 m a
step, and the ped maps, ped vectors and proximity rewards the policy and the
loss read drift with them.  Done, arrival and collision codes are held
exactly; actions and values within 5e-4, rewards within 1e-2 (the paper
reward's 200 * step_ds and ped-proximity terms), poses within 5e-4,
metrics within rtol 1e-3 and parameters within 2e-5 (they move by ~5e-3).
"""

from tests.test_torch_ppo import check_step, step_pair


def test_train_step_matches_jax_sfm_crowd():
    check_step(step_pair("sfm"), dict(act=5e-4, logp=1e-5, value=5e-4,
                                      reward=1e-2, pose=5e-4, metrics=1e-3,
                                      params=2e-5))
