"""Scene-batched environment (torch port of
``img_env_tpu.parallel.batched_env``).

``BatchedNavEnv`` steps S independent scenes of one config together, the
replacement for the reference's one-ROS-node-per-scene fan-out
(create_launch.py:25-34).  States carry a leading [S] axis on every
tensor.  The robot dynamics and the sensor pipeline run flat over the S*N
robots (``NavEnv.advance_scenes`` / ``NavEnv.observe_scenes``): one K1
launch rasters every scene, K2 and K3 run once per sensor group, K4 once.
The crowd steps scene by scene.

    env = BatchedNavEnv(cfg, device="cuda")
    states, obs = env.reset(4)                      # 4 scenes
    states, obs, reward, done, info = env.step(states, actions)  # [S,N,3]

Draws: the port's own layouts come from the core env's one
``torch.Generator``, the S scenes drawn in order; the beeps of a step are
S*N draws from it.  They are not the JAX package's threefry draws (which
torch cannot reproduce); tests inject the JAX samples and beep draws.
"""

from __future__ import annotations

import torch

from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.core.state import map_tree, stack_trees
from img_env_tpu_torch.env.nav_env import NavEnv


class BatchedNavEnv:
    """S scenes of the same config, stepped together.

    reset(samples or S) -> (states, obs)      # every leaf gains a leading S
    step(states, actions [S,N,3]) -> (states, obs, reward [S,N], done, info)

    ``legacy_vmap=True`` steps the scenes one by one through the
    single-scene ``NavEnv`` (the port's own reference for the flat path,
    as the JAX package vmaps its whole single-scene step).  ``mesh``
    (sharding the scene axis over devices) is not ported.
    """

    def __init__(self, cfg: EnvConfig, device="cuda", seed: int = 0,
                 mesh=None, legacy_vmap: bool = False):
        if mesh is not None:
            raise NotImplementedError(
                "sharding scenes over a device mesh is not ported")
        self.cfg = cfg
        self.core = NavEnv(cfg, device, seed)
        self.device = self.core.device
        self.legacy_vmap = legacy_vmap

    def reset(self, samples=None, carry=None, static_maps=None):
        """``samples``: the scenes' layouts (a sequence of
        ``ScenarioSample``), or their number S (default
        ``cfg.num_scenes``), drawn in order from the core env's generator.
        ``carry``: the previous [S]-batched state, whose command history,
        ped velocities, gait and robot crowd velocities carry over, as in
        ``NavEnv.reset``.  ``static_maps``: [S, H, W] per-scene base maps
        (different worlds in one batch: the configured resolution, one
        shape)."""
        core = self.core
        if samples is None:
            samples = int(self.cfg.num_scenes)
        if isinstance(samples, int):
            samples = [core.sample_scenario() for _ in range(samples)]
        s = len(samples)
        pick = lambda tree, k: (None if tree is None
                                else map_tree(lambda x: x[k], tree))
        states = [core.reset_state_fn(
            samples[k], pick(carry, k),
            static_map=None if static_maps is None else static_maps[k])
            for k in range(s)]
        if self.legacy_vmap:
            return tuple(stack_trees(parts) for parts in
                         zip(*(core._observe(x) for x in states)))
        return core.observe_scenes(stack_trees(states))

    def step(self, states, actions, beep_u=None):
        """actions [S, N, 3]; ``beep_u``: optional [S, N] uniform draws for
        the beep response (default: the generator)."""
        core = self.core
        actions = torch.as_tensor(actions, device=self.device)
        if self.legacy_vmap:
            outs = [core.step_fn(
                map_tree(lambda x, k=k: x[k], states), actions[k],
                None if beep_u is None else beep_u[k])
                for k in range(actions.shape[0])]
            return (stack_trees([o[0] for o in outs]),
                    stack_trees([o[1] for o in outs]),
                    torch.stack([o[2] for o in outs]),
                    torch.stack([o[3] for o in outs]),
                    {key: torch.stack([o[4][key] for o in outs])
                     for key in outs[0][4]})
        states, alive, beeps = core.advance_scenes(states, actions, beep_u)
        states, obs = core.observe_scenes(states)
        return core.finish_step(states, obs, alive, beeps)


def rollout_with_obs(env: BatchedNavEnv, states, obs, steps: int,
                     policy_fn):
    """``steps`` steps of ``policy_fn(t, obs) -> [S, N, 3]`` actions, as a
    plain loop.  Returns (final_states, final_obs, rewards [T, S, N],
    dones [T, S, N])."""
    rewards, dones = [], []
    for t in range(steps):
        states, obs, reward, done, _ = env.step(states, policy_fn(t, obs))
        rewards.append(reward)
        dones.append(done)
    return states, obs, torch.stack(rewards), torch.stack(dones)
