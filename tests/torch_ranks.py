"""Rank functions of the port's multi-process tests.

Each runs in a process that ``img_env_tpu_torch.parallel.distributed.spawn``
starts (a gloo rank on the CPU) and imports only the port, so that a rank
starts in a few seconds; it returns what the test checks as JSON values.
The tests are ``tests/test_torch_multidev.py`` and
``tests/test_torch_distributed.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from card_common import field_errors as _field_errors
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.parallel.batched_env import (BatchedNavEnv,
                                                    rollout_with_obs)
from img_env_tpu_torch.parallel.mesh import host_mesh, make_mesh, scene_block


def sharded_env(cfg_dict: dict, scenes: int, steps: int, seed: int) -> dict:
    """``scenes`` scenes over the ranks (``host_mesh``), reset with the
    env's own draws and stepped ``steps`` times, against the unsharded
    batch of the same seed on this rank's rows; then ``rollout_with_obs``
    over the sharded env.  Returns the field errors per step, whether the
    layouts and the beeps were equal, the rollout's shapes, and whether a
    step given beep draws of this rank's scenes only (not the global
    ones) raises."""
    torch.set_num_threads(1)
    n = dist.get_world_size()
    mesh = host_mesh(n)
    cfg = EnvConfig.from_dict(cfg_dict)
    sharded = BatchedNavEnv(cfg, "cpu", seed=seed, mesh=mesh)
    whole = BatchedNavEnv(cfg, "cpu", seed=seed)
    blk = scene_block(mesh, scenes)
    rows = lambda tree: type(tree)(*(None if x is None else x[blk]
                                     for x in tree))
    n_rob = cfg.robot.total
    # robot 0 beeps (v_y > 0), so the beeps read the draws
    base = np.tile(np.asarray([[0.4, 0.3, 1.0]] + [[0.5, -0.2, 0.0]]
                              * (n_rob - 1), np.float32), (scenes, 1, 1))
    actions = torch.as_tensor(base)
    st_s, obs_s = sharded.reset(scenes)
    st_w, obs_w = whole.reset(scenes)
    layouts = bool(torch.equal(st_s.robots.pose, st_w.robots.pose[blk])
                   and torch.equal(st_s.obstacles.pose,
                                   st_w.obstacles.pose[blk]))
    errors, beeps = [_field_errors(obs_s, rows(obs_w))], True
    for _ in range(steps):
        st_s, obs_s, _, _, info_s = sharded.step(st_s, actions[blk])
        st_w, obs_w, _, _, info_w = whole.step(st_w, actions)
        errors.append(_field_errors(obs_s, rows(obs_w)))
        beeps &= bool(torch.equal(info_s["beeps"], info_w["beeps"][blk]))
    _, _, rewards, dones = rollout_with_obs(
        sharded, st_s, obs_s, 2, lambda t, obs: actions[blk])
    try:     # beep draws of this rank's scenes only, as its actions
        sharded.step(st_s, actions[blk], beep_u=torch.zeros(
            blk.stop - blk.start, n_rob))
        local_beeps_raise = False
    except ValueError:
        local_beeps_raise = True
    return {"errors": errors, "layouts": layouts, "beeps": beeps,
            "local_beeps_raise": local_beeps_raise,
            "beep_count": int(info_w["beeps"].sum()),
            "rollout": [list(rewards.shape), list(dones.shape)],
            "block": [blk.start, blk.stop]}


def _train_step(cfg_dict: dict, unroll: int, mesh, seed: int,
                minibatches: int = 4):
    """A train step of a fresh ``CrowdNavPolicy`` over ``cfg_dict``'s
    env (sharded when ``mesh`` is given), ``minibatches`` a epoch, clip +
    sgd as tests/test_torch_ppo.py compares a whole step."""
    from img_env_tpu_torch.models.policy import CrowdNavPolicy, PolicyConfig
    from img_env_tpu_torch.train import optim, ppo

    cfg = EnvConfig.from_dict(cfg_dict)
    env = BatchedNavEnv(cfg, "cpu", seed=seed, mesh=mesh)
    model = CrowdNavPolicy(PolicyConfig.from_env_config(cfg))
    tx = optim.chain(optim.clip_by_global_norm(0.5), optim.sgd(0.05))
    pcfg = ppo.PpoConfig(unroll=unroll, minibatches=minibatches)
    return (env, model, pcfg) + ppo.make_train_step(env, model, pcfg, tx=tx)


def _first_minibatch(cfg_dict, scenes, unroll, mesh, seed, params):
    """A rollout of ``params`` from a reset of ``scenes`` scenes, then the
    gradient of the minibatch of every sample (``minibatch_grads``);
    returns (grads, loss terms, the one-process model, pcfg, data)."""
    from img_env_tpu_torch.train import ppo

    env, model, pcfg, init_fn, step = _train_step(cfg_dict, unroll, mesh,
                                                  seed)
    states, obs = env.reset(scenes)
    gen = torch.Generator().manual_seed(seed + 1)
    _, obs, traj = step.rollout(params, states, obs, gen, None)
    last_value = step.forward(params, ppo.obs_features(
        obs, env.cfg.ped_sim.total > 0))[-1]
    data, _ = ppo.rollout_data(traj, last_value, pcfg)
    idx = torch.arange(unroll * scenes * env.cfg.robot.total)
    grads, m = step.minibatch_grads(params, data, idx)
    return grads, m, model, pcfg, data


def sharded_update(cfg_dict: dict, scenes: int, unroll: int, seed: int,
                   model_axis: int, minibatches: int = 4) -> dict:
    """One PPO update (``minibatches`` a epoch) sharded over a
    [world / model_axis, model_axis] mesh, and on this rank the same
    update in one process, from the same seeds (the draw rule makes the
    rollouts equal).  Returns the sharded
    loss and its bits, a digest of the updated parameters, the step count,
    how far the parameters moved, the largest difference from the
    one-process update's parameters, its loss; and for the minibatch of
    every sample of a fresh rollout, the worst ratio of the sharded
    gradient's difference from the one-process one over the error model
    (``ppo.grad_error_ratios``)."""
    from img_env_tpu_torch.train import ppo

    torch.set_num_threads(1)
    mesh = make_mesh(model=model_axis, device_type="cpu")
    params = _fresh_params(cfg_dict, seed)
    out = {}
    for name, m in (("sharded", mesh), ("one", None)):
        env, _, _, init_fn, step = _train_step(cfg_dict, unroll, m, seed,
                                               minibatches)
        states, obs = env.reset(scenes)
        ts, _, _, met = step(init_fn(params), states, obs,
                             torch.Generator().manual_seed(seed + 1))
        out[name] = (ts, met)
    (ts, met), (ts_one, met_one) = out["sharded"], out["one"]
    g_sh, m_sh, _, _, _ = _first_minibatch(cfg_dict, scenes, unroll, mesh,
                                           seed, params)
    g_one, m_one, model, pcfg, data = _first_minibatch(
        cfg_dict, scenes, unroll, None, seed, params)
    ratio = max(ppo.grad_error_ratios(
        g_sh, g_one, ppo.grad_term_sums(model, params, data, pcfg)).values())
    return {"loss": float(met["loss"]), "loss_hex": float(met["loss"]).hex(),
            "one_loss": float(met_one["loss"]), "step": int(ts.step),
            "digest": _digest(ts.params),
            "moved": max(float((ts.params[k] - v).abs().max())
                         for k, v in params.items()),
            "param_diff": max(float((ts.params[k] - v).abs().max())
                              for k, v in ts_one.params.items()),
            "grad_ratio": ratio,
            "mb_loss": [float(m_sh[0]), float(m_one[0])]}


def _fresh_params(cfg_dict: dict, seed: int):
    from img_env_tpu_torch.models.policy import PolicyConfig, init_policy

    cfg = EnvConfig.from_dict(cfg_dict)
    return init_policy(torch.Generator().manual_seed(seed),
                       PolicyConfig.from_env_config(cfg), "cpu")[1]


def _digest(params) -> str:
    """A hash of the parameters' bytes."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def tp_plan(cfg_dict: dict, seed: int) -> dict:
    """On a 2 x 2 [scene, model] mesh: the tensor-parallel plan of a fresh
    policy of ``cfg_dict`` (each placement's repr), its sharded fraction,
    the largest error of ``tp_forward`` against the replicated forward
    relative to atol = rtol = 1e-5, ``shard_scenes`` of a 4-scene tensor,
    and whether 3 scenes raise."""
    from img_env_tpu_torch.models.policy import (PolicyConfig, example_inputs,
                                                 init_policy)
    from img_env_tpu_torch.parallel.mesh import (shard_scenes,
                                                 tp_param_shardings,
                                                 tp_sharded_fraction)
    from img_env_tpu_torch.parallel.tp import tp_forward

    torch.set_num_threads(1)
    mesh = make_mesh(scene=2, model=2, device_type="cpu")
    cfg = EnvConfig.from_dict(cfg_dict)
    pcfg = PolicyConfig.from_env_config(cfg)
    model, params = init_policy(torch.Generator().manual_seed(seed), pcfg,
                                "cpu")
    plan = tp_param_shardings(params, mesh)
    gen = torch.Generator().manual_seed(seed + 1)
    sm, vs, pm, pv = example_inputs(pcfg, batch=4, device="cpu")
    sm = sm + torch.randn(sm.shape, generator=gen) * 0.1
    pm = pm + torch.rand(pm.shape, generator=gen)
    pv = pv + torch.rand(pv.shape, generator=gen)
    pv[:, 0] = torch.tensor([0.0, 1.0, 2.0, 3.0])     # visible ped counts
    vs = vs + 1.0
    from torch.func import functional_call

    with torch.no_grad():
        want = functional_call(model, params, (sm, vs, pm, pv))
        got = tp_forward(model, params, plan, mesh.get_group("model"),
                         sm, vs, pm, pv)
    worst = max(float(((g - w).abs() / (1e-5 + 1e-5 * w.abs())).max())
                for g, w in zip(got, want))
    try:
        shard_scenes(mesh, torch.zeros(3, 2))
        raises = False
    except ValueError:
        raises = True
    return {"plan": {k: [repr(p) for p in v] for k, v in plan.items()},
            "fraction": tp_sharded_fraction(params, plan),
            "forward_ratio": worst,
            "shard": shard_scenes(mesh, torch.arange(4)).tolist(),
            "indivisible_raises": raises}
