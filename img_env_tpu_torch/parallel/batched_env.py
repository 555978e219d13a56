"""Scene-batched environment (torch port of
``img_env_tpu.parallel.batched_env``).

``BatchedNavEnv`` steps S independent scenes of one config together, the
replacement for the reference's one-ROS-node-per-scene fan-out
(create_launch.py:25-34).  States carry a leading [S] axis on every
tensor.  The robot dynamics and the sensor pipeline run flat over the S*N
robots (``NavEnv.advance_scenes`` / ``NavEnv.observe_scenes``): one K1
launch rasters every scene, K2 and K3 run once per sensor group, K4 once.
The crowd steps every scene at once (SFM, ORCA, the replay, the gait).

    env = BatchedNavEnv(cfg, device="cuda")
    states, obs = env.reset(4)                      # 4 scenes
    states, obs, reward, done, info = env.step(states, actions)  # [S,N,3]

Draws: the port's own layouts come from the core env's one
``torch.Generator``, the S scenes drawn in order; the beeps of a step are
S*N draws from it.  They are not the JAX package's threefry draws (which
torch cannot reproduce); tests inject the JAX samples and beep draws.

With a ``mesh`` (``parallel/mesh.py``) each rank steps only its own block
of the S scenes (``scene_block``) through the same flat path.  Every rank
draws from its generator exactly what the unsharded batch draws, in the
same order (all S layouts of a reset, all S*N beep draws of a step), and
keeps its block: a sharded run is the unsharded run, bit for bit, on each
rank's scenes.
"""

from __future__ import annotations

import torch

from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.core.state import map_tree, stack_trees
from img_env_tpu_torch.env.nav_env import NavEnv
from img_env_tpu_torch.parallel.mesh import scene_block
from img_env_tpu_torch.utils import trace


class BatchedNavEnv:
    """S scenes of the same config, stepped together.

    reset(samples or S) -> (states, obs)      # every leaf gains a leading S
    step(states, actions [S,N,3]) -> (states, obs, reward [S,N], done, info)

    ``legacy_vmap=True`` steps the scenes one by one through the
    single-scene ``NavEnv`` (the port's own reference for the flat path,
    as the JAX package vmaps its whole single-scene step).  ``mesh``
    shards the scene axis over the mesh's scene ranks: ``reset`` takes the
    global scenes and keeps this rank's block, and states, observations
    and actions are this rank's block.
    """

    def __init__(self, cfg: EnvConfig, device="cuda", seed: int = 0,
                 mesh=None, legacy_vmap: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        self.core = NavEnv(cfg, device, seed)
        self.device = self.core.device
        self.legacy_vmap = legacy_vmap

    def block(self, scenes: int) -> slice:
        """This rank's block of ``scenes`` global scenes (all of them
        without a mesh)."""
        return (slice(0, scenes) if self.mesh is None
                else scene_block(self.mesh, scenes))

    def global_scenes(self, local: int) -> int:
        """The global scene count of a local block of ``local`` scenes."""
        return local if self.mesh is None else local * self.mesh.size(0)

    def reset(self, samples=None, carry=None, static_maps=None):
        """``samples``: the scenes' layouts (a sequence of
        ``ScenarioSample``), or their number S (default
        ``cfg.num_scenes``), drawn in order from the core env's generator;
        with a mesh, all S global scenes, of which this rank resets its
        block.  ``carry``: the previous [S]-batched state (this rank's
        block), whose command history, ped velocities, gait and robot
        crowd velocities carry over, as in ``NavEnv.reset``.
        ``static_maps``: [S, H, W] per-scene base maps of the global scenes
        (different worlds in one batch: the configured resolution, one
        shape)."""
        core = self.core
        if samples is None:
            samples = int(self.cfg.num_scenes)
        if isinstance(samples, int):
            samples = [core.sample_scenario() for _ in range(samples)]
        blk = self.block(len(samples))
        return self.reset_local(
            samples[blk], carry,
            None if static_maps is None else static_maps[blk])

    def reset_local(self, samples, carry=None, static_maps=None):
        """``reset`` of exactly these scenes on this rank (no block taken):
        the autoreset's redraw of a rank's finished scenes."""
        core = self.core
        pick = lambda tree, k: (None if tree is None
                                else map_tree(lambda x: x[k], tree))
        with trace.span("batch.reset_local"):
            trace.count("reset.scenes", len(samples))
            with trace.span("reset.states"):
                states = [core.reset_state_fn(
                    samples[k], pick(carry, k),
                    static_map=None if static_maps is None
                    else static_maps[k])
                    for k in range(len(samples))]
            if self.legacy_vmap:
                return tuple(stack_trees(parts) for parts in
                             zip(*(core._observe(x) for x in states)))
            return core.observe_scenes(stack_trees(states))

    @trace.spanned("env.step")
    def step(self, states, actions, beep_u=None):
        """actions [S, N, 3] (with a mesh, this rank's block); ``beep_u``:
        optional [S, N] uniform draws for the beep response of the global
        scenes, all of them also with a mesh (default: the generator; with
        a mesh all S*N are drawn and this rank keeps its block)."""
        core = self.core
        actions = torch.as_tensor(actions, device=self.device)
        if self.mesh is not None:
            s, n = actions.shape[:2]
            s_all = self.global_scenes(s)
            if beep_u is None:
                beep_u = torch.rand(
                    s_all * n, generator=core.generator, device=self.device,
                    dtype=states.robots.pose.dtype).reshape(s_all, n)
            elif beep_u.shape[0] != s_all:
                raise ValueError(
                    f"beep_u holds {beep_u.shape[0]} scenes; under a mesh "
                    f"it takes all {s_all} global scenes")
            beep_u = beep_u[self.block(s_all)]
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
