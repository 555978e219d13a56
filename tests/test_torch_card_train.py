"""The training path and the mesh on the card, under torch's default TF32
flags (the training code turns TF32 off where it must):

* one train step of a small crowd config card vs CPU on injected draws;
* the stage-5 continuation at full width through train/run.py
  (``card_common.TRAIN_ARGS``): K1-K4 once an env step and a reset, the
  reward floor, a checkpoint round trip; an unroll without host syncs,
  whose samples hold the card's full-width gradient to the CPU's within
  ``train.ppo``'s error model, while a bare backward (TF32 on for cuDNN)
  falls outside it;
* three 50-update runs from scratch on easy_train's config, whose mean
  reward rises;
* a mesh of one (NCCL) bit-equal to no mesh; the production-shape batch
  sharded over two ranks on the card (gloo, its statics from a warm
  cache), each rank bit-equal to the unsharded batch on its scenes; one
  PPO update sharded over two ranks.

These need an NVIDIA GPU and nvcc and skip without them.  On the machine
with the card (which has no JAX) run them without the JAX test conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py tests/test_torch_card_*.py

This file imports nothing of JAX.
"""

import copy
import math
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

import card_common as cc
from img_env_tpu_torch import BatchedNavEnv, EnvConfig, NavEnv
from img_env_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def world_of_one(dev):
    """train/run.py and the mesh start a world of one; end it after the
    module."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_small_train_step_card_equals_cpu(dev):
    """One train step of a small crowd config (SMALL_PED, 2 scenes,
    unroll 4, 2 epochs x 2 minibatches, clip 0.5 + sgd 0.05) on the card
    and on the CPU from one fresh policy, one set of layouts and the same
    injected draws (Gaussian noise, reset layouts, permutations); scene 0
    starts 2 steps before time_max, so the autoreset redraws it.  Done
    codes, the final collision and arrival codes, the step counts and the
    scenes reset must be equal, the parameters within STEP_TOL of each
    other and moved by more than 100 times it."""
    from img_env_tpu_torch.models.policy import (CrowdNavPolicy,
                                                 PolicyConfig, init_policy)
    from img_env_tpu_torch.train import optim, ppo

    cfg = EnvConfig.from_dict(cc.SMALL_PED)
    s, t, epochs = 2, 4, 2
    pcfg = ppo.PpoConfig(unroll=t, epochs=epochs, minibatches=2,
                         reward_scale=0.02)
    gen = torch.Generator().manual_seed(0)
    pol_cfg = PolicyConfig.from_env_config(cfg)
    _, params0 = init_policy(gen, pol_cfg, "cpu")
    env_c = BatchedNavEnv(cfg, "cpu")
    samples = [env_c.core.sample_scenario() for _ in range(2 * s)]
    b = s * cfg.robot.total
    eps = torch.randn((t, b, cfg.act_dim), generator=gen)
    perms = torch.stack([torch.randperm(t * b, generator=gen)
                         for _ in range(epochs)])
    out = {}
    for d in ("cpu", dev):
        env = env_c if d == "cpu" else BatchedNavEnv(cfg, d)
        params = {k: v.to(d) for k, v in params0.items()}
        init_fn, step = ppo.make_train_step(
            env, CrowdNavPolicy(pol_cfg).to(d), pcfg,
            tx=optim.chain(optim.clip_by_global_norm(0.5), optim.sgd(0.05)))
        states, obs = env.reset([cc.to_device(x, d) for x in samples[:s]])
        states = states._replace(step=torch.tensor(
            [cfg.time_max - 2, 0], dtype=torch.int32, device=d))
        draws = ppo.Draws(eps.to(d), [cc.to_device(x, d)
                                      for x in samples[s:]], perms.to(d))
        traj = step.rollout(params, states, obs, None, draws.eps)[2]
        ts, states, obs, m = step(init_fn(params), states, obs, None, draws)
        out[d] = (torch.stack([x[5] for x in traj]).cpu(), ts, states, m)
    (done_c, ts_c, st_c, m_c), (done_g, ts_g, st_g, m_g) = out["cpu"], out[dev]
    assert torch.equal(done_c, done_g)
    for f in ("collision", "arrive"):
        assert torch.equal(getattr(st_c.robots, f),
                           getattr(st_g.robots, f).cpu()), f
    assert torch.equal(st_c.step, st_g.step.cpu())
    assert m_c["reset_scenes"] == m_g["reset_scenes"] >= 1
    worst = max(float((ts_g.params[k].cpu() - v).abs().max())
                for k, v in ts_c.params.items())
    moved = max(float((ts_c.params[k] - v).abs().max())
                for k, v in params0.items())
    assert worst <= cc.STEP_TOL and moved > 100 * cc.STEP_TOL, (worst, moved)


@pytest.fixture(scope="module")
def stage5_run(dev):
    """The stage-5 continuation through train/run.py's code path
    (TRAIN_ARGS, 3 updates), every env step launching K1-K4 once and K5
    never; returns train()'s result, the step and reset counts and the
    launches of the whole run."""
    from img_env_tpu_torch.train import run

    args = run.parse_args(cc.TRAIN_ARGS)
    before = dict(kernels.LAUNCHES)
    with cc.StepLaunches(cc.CROWD) as counted:
        res = run.train(args, log=lambda line: None)
    return res, args, counted, cc.launch_delta(before)


def test_stage5_continuation(dev, stage5_run):
    """3 updates of unroll 16: 48 env steps, each launching K1-K4 once,
    and each reset once more (K5 never), the EDT kernel once for every
    scene reset; the loss terms finite; the mean reward_mean at least
    REWARD_FLOOR; the parameters moved; the train
    state survives a checkpoint round trip bit for bit, and
    ``load_ckpt_policy`` acts from a saved checkpoint; K1-K4 bit-equal to
    their twins at the 32 scenes' last states."""
    from img_env_tpu_torch.models.policy import load_ckpt_policy
    from img_env_tpu_torch.train import checkpoint, run

    res, args, counted, launches = stage5_run
    assert counted.steps == cc.TRAIN_UPDATES * args.unroll
    want = dict.fromkeys(launches, 0)
    want.update({k: counted.steps + counted.resets for k in cc.CROWD},
                edt=counted.reset_scenes)
    assert launches == want
    for m in res["metrics"]:
        for k in ("loss", "pg_loss", "vf_loss", "entropy"):
            assert bool(torch.isfinite(torch.as_tensor(m[k]))), (k, m)
    reward_mean = float(res["history"][:, 1].mean())
    assert reward_mean >= cc.REWARD_FLOOR
    env, ts, cfg = res["env"], res["ts"], res["env"].cfg
    start = run.restore_params(cc.POLICY_NPZ, ts.params)
    assert max(float((ts.params[k] - v).abs().max())
               for k, v in start.items() if k != "pi_log_std") > 0
    with tempfile.TemporaryDirectory() as tmp:
        path = tmp + "/stage5_train.pt"
        checkpoint.save(path, {"ts": ts})
        back = checkpoint.restore(path, like={"ts": ts},
                                  device=env.device)["ts"]
        leaves = lambda t: [t.step, *t.params.values(),
                            *t.opt_state[1][0].mu.values(),
                            *t.opt_state[1][0].nu.values(),
                            t.opt_state[1][0].count]
        assert all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                     leaves(ts)))
        checkpoint.save(path, {"params": ts.params})
        policy_fn, _ = load_ckpt_policy(cfg, path, env.device)
        act = policy_fn(None, res["obs"])
    assert act.shape == (args.scenes, cfg.robot.total, cfg.act_dim)
    assert bool(torch.isfinite(act).all())
    cc.kernels_match_twins(env, res["states"])


@pytest.fixture(scope="module")
def unroll(stage5_run):
    """An unroll of the trained policy with host syncs made errors, and
    its samples as PPO's rollout data."""
    from torch.func import functional_call

    from img_env_tpu_torch.train import ppo

    res, args, _, _ = stage5_run
    model, ts = res["model"], res["ts"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, obs_r, traj = res["train_step"].rollout(
            ts.params, res["states"], res["obs"], res["generator"], None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    pcfg = ppo.PpoConfig(unroll=args.unroll, lr=args.lr, epochs=args.epochs,
                         minibatches=args.minibatches,
                         ent_coef=args.ent_coef,
                         reward_scale=args.reward_scale)
    with torch.no_grad():
        last_value = functional_call(model, ts.params, ppo.obs_features(
            obs_r, True))[-1]
    data, _ = ppo.rollout_data(traj, last_value, pcfg)
    return data, pcfg


def test_stage5_unroll_without_syncs(dev, stage5_run, unroll):
    """The rollout of an update (policy forward, draw, env step, reward)
    makes no host sync: ``unroll`` runs it under
    ``set_sync_debug_mode("error")``; its samples cover every step of
    every robot."""
    res, args, _, _ = stage5_run
    data, _ = unroll
    assert data[1].shape[0] == args.unroll * args.scenes * \
        res["env"].cfg.robot.total


def test_train_gradients_card_equals_cpu(dev, stage5_run, unroll):
    """The loss and every gradient leaf of one minibatch of GRAD_SAMPLES
    at full width on the card (``loss_and_grads``: TF32 off in the
    forward and the backward) against the same on the CPU: the loss within
    1e-4 of itself, each leaf within the error model
    (``ppo.grad_error_ratios`` over ``ppo.grad_term_sums``); then the
    control, a bare ``loss.backward()`` outside the guard under torch's
    default flags, which the tolerance must catch."""
    from img_env_tpu_torch.train import ppo

    res = stage5_run[0]
    model, params, gen = res["model"], res["ts"].params, res["generator"]
    data, pcfg = unroll
    idx = torch.randperm(data[1].shape[0], generator=gen,
                         device=gen.device)[:cc.GRAD_SAMPLES]
    mb = ppo.take(data, idx)
    loss_g, _, grads_g = ppo.loss_and_grads(model, params, mb, pcfg)
    cpu = lambda x: None if x is None else x.cpu()
    mb_c = (tuple(cpu(f) for f in mb[0]), *(cpu(x) for x in mb[1:]))
    loss_c, _, grads_c = ppo.loss_and_grads(
        copy.deepcopy(model).cpu(), {k: v.cpu() for k, v in params.items()},
        mb_c, pcfg)
    assert abs(float(loss_g) - float(loss_c)) <= 1e-4 * abs(float(loss_c))
    sums = ppo.grad_term_sums(model, params, mb, pcfg)
    ratios = ppo.grad_error_ratios(grads_g, grads_c, sums)
    assert max(ratios.values()) <= 1.0, {k: r for k, r in ratios.items()
                                         if r > 1.0}
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, _ = ppo.minibatch_loss(model, p, mb, pcfg)
    loss.backward()
    control = ppo.grad_error_ratios({k: v.grad for k, v in p.items()},
                                    grads_c, sums)
    assert max(control.values()) > 1.0


def test_easy_train_rises(dev):
    """Learning from scratch: README.md:101-104's settings on
    easy_train.yaml's config (EASY_ARGS) through train/run.py, once for
    each of EASY_SEEDS; the mean over the runs of their last-10 mean
    reward_mean exceeds that of their first-10 means."""
    from img_env_tpu_torch.train import run

    curves = []
    for seed in cc.EASY_SEEDS:
        args = list(cc.EASY_ARGS)
        args[args.index("--seed") + 1] = str(seed)
        res = run.train(run.parse_args(args),
                        cfg=EnvConfig.from_dict(cc.EASY_TRAIN),
                        log=lambda line: None)
        curves.append(res["history"][:, 1])
    curves = np.stack(curves)
    assert curves[:, -10:].mean() > curves[:, :10].mean(), curves.tolist()


def test_mesh_of_one_bit_equal(dev):
    """The stage-5 continuation over ``make_mesh()`` (a world of one rank,
    NCCL for CUDA tensors) against the same without a mesh, from the same
    seeds, with cuDNN's deterministic algorithms: the minibatch gradient,
    the loss terms, the update's loss and parameters are bit-equal."""
    from img_env_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    assert (mesh.size(0), mesh.size(1), dist.get_world_size()) == (1, 1, 1)
    assert "cuda:nccl" in dist.get_backend_config()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        a, b = cc.stage5_update(mesh), cc.stage5_update(None)
    finally:
        torch.backends.cudnn.deterministic = saved
    for k, v in b["grads"].items():
        assert torch.equal(a["grads"][k], v), k
    assert torch.equal(a["terms"], b["terms"])
    assert torch.equal(a["loss"], b["loss"])
    for k, v in b["params"].items():
        assert torch.equal(a["params"][k], v), k


def _ranks(fn: str, args=(), env=None):
    """``card_common.<fn>`` in MESH_RANKS spawned ranks on the card
    (gloo: two ranks share one card); each rank's result."""
    from img_env_tpu_torch.parallel.distributed import spawn

    runs = spawn(f"card_common:{fn}", cc.MESH_RANKS, args,
                 backend="gloo", timeout_s=400.0, pg_timeout_s=120.0,
                 env=env)
    for k, r in enumerate(runs):
        assert r.rc == 0 and r.result is not None, (k, r.rc, r.err[-6000:])
    return [r.result for r in runs]


def test_two_rank_batch(dev, tmp_path, monkeypatch):
    """PRODUCTION's 8 scenes sharded over two ranks on the card, their
    statics read from a cache this process wrote
    (IMG_ENV_TPU_STATICS_CACHE): each rank holds its block of 4 scenes,
    equals the unsharded batch on its scenes over the reset and 3 steps
    (sensor maps, lasers, angular maps and codes bit for bit, the vector
    fields within 1e-12), and launches K1 once, K2 and K3 once per sensor
    group (2) and K4 once a step, and the EDT kernel never (no step
    resets)."""
    from img_env_tpu_torch.utils import statics_cache

    monkeypatch.setenv(statics_cache.ENV_VAR, str(tmp_path))
    for _ in range(2):              # cold, then warm through the cache
        NavEnv(EnvConfig.from_dict(cc.PRODUCTION), dev)
    assert any(tmp_path.iterdir())
    runs = _ranks("card_batch_rank", (cc.MESH_SCENES, cc.MESH_STEPS))
    per_step = {"raster": 1, "fill": 2, "paint": 2, "pedmap": 1,
                "paint_block": 0, "edt": 0}
    half = cc.MESH_SCENES // cc.MESH_RANKS
    for k, r in enumerate(runs):
        assert r["block"] == [k * half, (k + 1) * half]
        for t, e in enumerate(r["errors"]):
            bad = {f: v for f, v in e.items()
                   if (v > 0 if f in cc.BITEXACT else v > 1e-12)}
            assert not bad, (k, t, bad)
        assert r["launches"] == {name: c * cc.MESH_STEPS
                                 for name, c in per_step.items()}, k


def test_two_rank_update(dev):
    """One PPO update of the stage-5 continuation sharded over two ranks
    on the card (16 of its 32 scenes each): the loss finite and, with the
    updated parameters, bit-equal on both ranks; the minibatch gradient
    summed over the ranks within the error model around the one-process
    gradient of the same global samples."""
    for k, r in enumerate(_ranks("card_update_rank")):
        assert r["loss_equal"] and r["params_equal"], (k, r)
        assert math.isfinite(r["loss"]), (k, r)
        assert r["grad_ratio"] <= 1.0, (k, r)
