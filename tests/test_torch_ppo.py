"""The port's PPO trainer (``img_env_tpu_torch.train``) against the JAX
package's (``img_env_tpu.train.ppo``) on inputs made with numpy from a
seed: GAE, the minibatch loss and every gradient leaf, the optax rules
(``clip_by_global_norm`` + ``adam``), and one whole ``train_step`` with the
JAX draws injected; then the port's own: the gradient clip's bound,
``init_policy``'s distributions, checkpoints, the npz warm start and the
``train.run`` entry point.

The JAX side runs jitted under ``jax.enable_x64(False)``; its inner
functions (``gae``, ``minibatch_loss``, ``rollout``) are taken from
``make_train_step``'s closure, so the port is held to the code that trains.
Both sides are float32 on the CPU and sum in different orders; each test
states its tolerance.  A whole train step compares with
``tx = clip_by_global_norm + sgd``: Adam's first step is ~lr * sign(g), and
where |g| is rounding noise the two sides could step 2 lr apart.
"""

import functools
import json
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tests.test_torch_env  # noqa: F401  (one torch thread per worker)
from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.models import policy as jpolicy
from img_env_tpu.parallel.batched_env import BatchedNavEnv as JaxBatchedNavEnv
from img_env_tpu.train.ppo import PpoConfig as JaxPpoConfig
from img_env_tpu.train.ppo import make_train_step as jax_make_train_step
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.models import policy as tpolicy
from img_env_tpu_torch.parallel import BatchedNavEnv
from img_env_tpu_torch.train import checkpoint, optim, ppo, run
from tests.test_torch_multiscene import cfg_dict as sfm_cfg_dict
from tests.test_torch_multiscene import jax_samples
from tests.test_torch_policy import observations
from tools.export_policy_npz import flat_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(REPO, "img_env_tpu_torch", "artifacts")

# tests/test_ppo.py's easy config: 1 robot in the empty 10 m room
EASY = {
    "robot": {"total": 1, "begin_poses_type": ["range"],
              "begin_poses": [[2.0, 8.0, 2.0, 8.0]],
              "target_poses_type": ["range"],
              "target_poses": [[2.0, 8.0, 2.0, 8.0]]},
    "ped_sim": {"total": 0},
    "global_map": {"map_file": "room_10.png", "resolution": 0.1},
    "view_map": {"resolution": 0.1, "width": 3.0, "height": 3.0},
    "range_total": 24,
    "image_size": [48, 48],
    "time_max": 40,
    "num_scenes": 2,
}
# tests/test_multiscene_flat.py's config: 2 robots, 3 rectangles, 2 SFM
# leg peds, 3 m views at 0.05 m, 64 beams, max_ped 3
SFM = dict(sfm_cfg_dict(2, "pedscene"), time_max=40)


def _closure(fn):
    """The variables a JAX function closes over (make_train_step's inner
    functions)."""
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def _to_port(tree):
    """A flax parameter-shaped tree (params, grads, adam moments) as the
    port's state dict."""
    return tpolicy.policy_params_from_numpy(flat_params(tree))


@functools.lru_cache(maxsize=None)
def _jax_parts(name, **ppo_kw):
    """The JAX config, model, a flax init and make_train_step's inner
    functions for a config (its env only read for its config)."""
    d = {"easy": EASY, "sfm": SFM}[name]
    with jax.enable_x64(False):
        jcfg = JaxEnvConfig.from_dict(d)
        pcfg = jpolicy.PolicyConfig.from_env_config(jcfg)
        model, params = jpolicy.init_policy(jax.random.PRNGKey(0), pcfg,
                                            batch=2)
        cfg = JaxPpoConfig(**ppo_kw)
        _, train_step = jax_make_train_step(
            types.SimpleNamespace(cfg=jcfg), model, cfg)
    return jcfg, model, params, _closure(train_step)


def _port_model(d):
    cfg = EnvConfig.from_dict(d)
    return cfg, tpolicy.CrowdNavPolicy(tpolicy.PolicyConfig.from_env_config(
        cfg))


def test_gae_matches_jax_scan():
    """GAE over [T=7, B=5] with episode ends inside: within 2e-6 (XLA's
    scan may contract the multiply-adds)."""
    rng = np.random.default_rng(0)
    t, b = 7, 5
    values = rng.normal(0, 3, (t, b)).astype(np.float32)
    rewards = rng.normal(0, 1, (t, b)).astype(np.float32)
    dones = (rng.uniform(size=(t, b)) < 0.2).astype(np.int32)
    last = rng.normal(0, 3, b).astype(np.float32)
    cfg = ppo.PpoConfig(gamma=0.97, lam=0.9)
    _, _, _, inner = _jax_parts("easy", gamma=0.97, lam=0.9)
    with jax.enable_x64(False):
        want = jax.jit(inner["gae"])(*map(jnp.asarray,
                                          (values, rewards, dones, last)))
    got = ppo.gae(*map(torch.as_tensor, (values, rewards, dones, last)),
                  cfg.gamma, cfg.lam)
    assert bool(dones.any())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


def _minibatch(name, seed=1, b=16):
    """Seeded minibatch inputs: the policy's observations (ped counts 0,
    partial, max_ped and above), actions drawn around the flax policy's
    mean, old log-probs within +-0.3 of the new (some ratios clip)."""
    jcfg, model, params, _ = _jax_parts(name)
    cfg = EnvConfig.from_dict({"easy": EASY, "sfm": SFM}[name])
    rng = np.random.default_rng(seed)
    sm, vs, pm, pv = observations(cfg, seed, b)
    feats = (sm, vs) + ((pm, pv) if cfg.ped_sim.total else (None, None))
    with jax.enable_x64(False):
        mean, log_std, _ = model.apply(
            params, *(None if x is None else jnp.asarray(x) for x in feats))
    mean, log_std = np.asarray(mean), np.asarray(log_std)
    act = (mean + np.exp(log_std) * rng.normal(0, 1, mean.shape)).astype(
        np.float32)
    logp = (-0.5 * ((act - mean) / np.exp(log_std)) ** 2 - log_std
            - 0.5 * np.log(2 * np.pi)).sum(-1)
    logp_old = (logp + rng.uniform(-0.3, 0.3, b)).astype(np.float32)
    advs = rng.normal(0.5, 2, b).astype(np.float32)
    returns = rng.normal(0, 3, b).astype(np.float32)
    return feats, act, logp_old, advs, returns


@pytest.mark.parametrize("name", ["easy", "sfm"])
def test_minibatch_loss_and_gradients_match_jax(name):
    """``minibatch_loss`` and the gradient of every parameter against
    ``jax.value_and_grad`` on a flax init converted to the port, without
    (easy) and with the ped map and attention branches (robots that see no
    ped and robots that see max_ped).  Loss and aux within rtol 1e-5; each
    gradient leaf within 1e-4 of its largest magnitude (float32, other sum
    orders through the convolutions' backward) plus 1e-8: the attention's
    key bias has an exact gradient of 0 (softmax ignores a constant added
    to a query's logits), and both sides hold rounding noise of ~1e-10
    there."""
    jcfg, model, params, inner = _jax_parts(name)
    feats, act, logp_old, advs, returns = _minibatch(name)
    with jax.enable_x64(False):
        mb = (tuple(None if x is None else jnp.asarray(x) for x in feats),
              *map(jnp.asarray, (act, logp_old, advs, returns)))
        (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(
            inner["minibatch_loss"], has_aux=True))(params, mb)
    cfg, pol = _port_model({"easy": EASY, "sfm": SFM}[name])
    p = _to_port(params)
    mb_t = (tuple(None if x is None else torch.as_tensor(x) for x in feats),
            *map(torch.as_tensor, (act, logp_old, advs, returns)))
    loss, aux, grads = ppo.loss_and_grads(pol, p, mb_t, ppo.PpoConfig())
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    for k in ("pg_loss", "vf_loss", "entropy"):
        np.testing.assert_allclose(float(aux[k]), float(aux_j[k]),
                                   rtol=1e-5, err_msg=k)
    want = _to_port(grads_j)
    assert list(grads) == list(p) and set(want) == set(grads)
    for k, g in grads.items():
        w = want[k].numpy()
        assert bool(torch.isfinite(g).all()), k
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * scale + 1e-8, err_msg=k)
    if name == "sfm":
        # the attention and ped trunk learn: their gradients are not zero
        assert float(grads["crowd_attn.query.weight"].abs().max()) > 0
        assert float(grads["ped_trunk.convs.0.weight"].abs().max()) > 0


@pytest.mark.parametrize("max_norm", [1e3, 0.05], ids=["below", "above"])
def test_clip_and_adam_match_optax(max_norm):
    """clip_by_global_norm + adam(lr) for 4 steps on injected gradients,
    from the optax state after one step (``adam_state_from_numpy``, so the
    bias corrections run at counts 2-5), below and above the clip
    threshold: parameters within rtol 2e-6 (float32 pow and the global
    norm's sum order); moments within rtol 2e-6 plus 1e-6 of the leaf's
    largest (XLA contracts b1 * mu + (1 - b1) * g into an FMA, so a moment
    that cancels to near 0 keeps a few more bits there)."""
    lr = 1e-3
    _, _, params, _ = _jax_parts("sfm")
    params = params["params"]
    rng = np.random.default_rng(2)
    grads = [jax.tree_util.tree_map(
        lambda x: rng.normal(0, 0.02, x.shape).astype(np.float32), params)
        for _ in range(5)]
    tx_j = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr))
    with jax.enable_x64(False):
        upd = jax.jit(lambda g, s, p: (lambda u, s2: (
            optax.apply_updates(p, u), s2))(*tx_j.update(g, s, p)))
        state_j = tx_j.init(params)
        p_j, state_j = upd(grads[0], state_j, params)
    adam_j = state_j[1][0]
    assert int(adam_j.count) == 1
    tx = optim.chain(optim.clip_by_global_norm(max_norm), optim.adam(lr))
    p_t = _to_port({"params": p_j})
    state = ((), (optim.adam_state_from_numpy(
        adam_j.count, _to_port({"params": adam_j.mu}),
        _to_port({"params": adam_j.nu}), "cpu"), ()))
    norm = []
    for g in grads[1:]:
        g_t = _to_port({"params": g})
        norm.append(float(optim.global_norm(g_t)))
        with jax.enable_x64(False):
            p_j, state_j = upd(g, state_j, p_j)
        u, state = tx.update(g_t, state, p_t)
        p_t = optim.apply_updates(p_t, u)
        want = _to_port({"params": p_j})
        for k in want:
            np.testing.assert_allclose(p_t[k].numpy(), want[k].numpy(),
                                       rtol=2e-6, atol=1e-9, err_msg=k)
    assert (min(norm) > max_norm) == (max_norm < 1)
    adam_j, adam_t = state_j[1][0], state[1][0]
    assert int(adam_t.count) == int(adam_j.count) == 5
    for mom in ("mu", "nu"):
        want = _to_port({"params": getattr(adam_j, mom)})
        for k in want:
            w = want[k].numpy()
            np.testing.assert_allclose(getattr(adam_t, mom)[k].numpy(), w,
                                       rtol=2e-6, atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"{mom} {k}")


# ---------------------------------------------------------------------------
# one whole train step, the JAX draws injected
# ---------------------------------------------------------------------------

S, T, EPOCHS, N_MB, LR, CLIP = 2, 4, 2, 2, 0.05, 0.5


class StepPair:
    """One JAX ``train_step`` (jitted) and the port's from the same layouts,
    parameters and draws, with ``tx = clip_by_global_norm(0.5) + sgd``.
    Scene 0 starts 2 steps before ``time_max``, so it finishes in the unroll
    and the autoreset redraws it; scene 1 runs on."""

    def __init__(self, d):
        ppo_kw = dict(unroll=T, epochs=EPOCHS, minibatches=N_MB,
                      reward_scale=0.02)
        with jax.enable_x64(False):
            jcfg = JaxEnvConfig.from_dict(d)
            env_j = JaxBatchedNavEnv(jcfg, mesh=None, jit=False)
            model_j, params_j = jpolicy.init_policy(
                jax.random.PRNGKey(0),
                jpolicy.PolicyConfig.from_env_config(jcfg), batch=2)
            init_fn, train_step = jax_make_train_step(
                env_j, model_j, JaxPpoConfig(**ppo_kw),
                tx=optax.chain(optax.clip_by_global_norm(CLIP),
                               optax.sgd(LR)))
            ts = init_fn(params_j)
            keys = jax.random.split(jax.random.PRNGKey(1), S)
            states, obs = jax.jit(env_j.reset_fn)(keys)
            states = states._replace(
                step=states.step.at[0].set(jcfg.time_max - 2))
            key = jax.random.PRNGKey(7)
            self.ts_j, self.states_j, self.obs_j, self.m_j = jax.jit(
                train_step)(ts, states, obs, key)
            # the unroll alone, for its trajectory
            k_roll, k_perm = jax.random.split(key)
            self.traj_j = jax.jit(_closure(train_step)["rollout"])(
                ts.params, states, obs, k_roll)[2]
            # the step's draws, from its key splits (ppo.py:216, 132-133,
            # 103, 151, 254, 236)
            k_steps, k_reset = jax.random.split(k_roll)
            b = S * jcfg.robot.total
            eps = np.stack([np.asarray(jax.random.normal(
                jax.random.split(k)[0], (b, jcfg.act_dim)))
                for k in jax.random.split(k_steps, T)])
            perms = np.stack([np.asarray(jax.random.permutation(k, T * b))
                              for k in jax.random.split(k_perm, EPOCHS)])
            draws = ppo.Draws(torch.as_tensor(eps),
                              jax_samples(env_j, jax.random.split(k_reset,
                                                                  S)),
                              torch.as_tensor(perms.astype(np.int64)))
            samples0 = jax_samples(env_j, keys)
        self.params0 = _to_port(params_j)
        self.params_j = _to_port(self.ts_j.params)
        cfg, model = _port_model(d)
        env = BatchedNavEnv(cfg, "cpu")
        states_t, obs_t = env.reset(samples0)
        states_t = states_t._replace(step=torch.as_tensor(
            np.array(states.step)))
        init_t, step_t = ppo.make_train_step(
            env, model, ppo.PpoConfig(**ppo_kw),
            tx=optim.chain(optim.clip_by_global_norm(CLIP), optim.sgd(LR)))
        ts_t = init_t(dict(self.params0))
        self.traj = step_t.rollout(ts_t.params, states_t, obs_t, None,
                                   draws.eps)[2]
        self.ts, self.states, self.obs, self.m = step_t(
            ts_t, states_t, obs_t, None, draws)


@functools.lru_cache(maxsize=None)
def step_pair(name):
    return StepPair({"easy": EASY, "sfm": SFM}[name])


def check_step(p: StepPair, tol):
    """Trajectory codes, resets and outcome rates exact; the float
    trajectory, metrics, states and parameters within ``tol``."""
    # done codes exact, floats to the stated tolerance
    done = torch.stack([x[5] for x in p.traj]).numpy()
    np.testing.assert_array_equal(done, np.asarray(p.traj_j[5]))
    for i, name in ((1, "act"), (2, "logp"), (3, "value"), (4, "reward")):
        got = torch.stack([x[i] for x in p.traj]).numpy()
        np.testing.assert_allclose(got, np.asarray(p.traj_j[i]), rtol=0,
                                   atol=tol[name], err_msg=name)
    # the autoreset: scene 0 finished and was redrawn as the JAX step
    # redrew it, scene 1 ran on
    assert p.m["reset_scenes"] == 1
    np.testing.assert_array_equal(p.states.step.numpy(),
                                  np.asarray(p.states_j.step))
    assert p.states.step.tolist() == [0, T]
    r, r_j = p.states.robots, p.states_j.robots
    for f in ("collision", "arrive"):
        np.testing.assert_array_equal(getattr(r, f).numpy(),
                                      np.asarray(getattr(r_j, f)), err_msg=f)
    for f in ("pose", "goal", "goal_yaw"):
        np.testing.assert_array_equal(getattr(r, f)[0].numpy(),
                                      np.asarray(getattr(r_j, f))[0],
                                      err_msg=f)
    np.testing.assert_array_equal(p.states.obs_map[0].numpy(),
                                  np.asarray(p.states_j.obs_map)[0])
    for f in ("sensor_maps", "lasers", "is_collisions", "is_arrives"):
        np.testing.assert_array_equal(getattr(p.obs, f)[0].numpy(),
                                      np.asarray(getattr(p.obs_j, f))[0],
                                      err_msg=f)
    np.testing.assert_allclose(r.pose[1].numpy(), np.asarray(r_j.pose)[1],
                               rtol=0, atol=tol["pose"])
    for k in ("arrive_rate", "collision_rate"):
        assert float(p.m[k]) == float(p.m_j[k]), k
    for k in ("loss", "pg_loss", "vf_loss", "entropy", "reward_mean"):
        np.testing.assert_allclose(float(p.m[k]), float(p.m_j[k]),
                                   rtol=tol["metrics"], err_msg=k)
    moved = max(float((p.params_j[k] - p.params0[k]).abs().max())
                for k in p.params0)
    assert moved > 100 * tol["params"]
    for k, w in p.params_j.items():
        np.testing.assert_allclose(p.ts.params[k].numpy(), w.numpy(),
                                   rtol=0, atol=tol["params"], err_msg=k)
    assert int(p.ts.step) == int(p.ts_j.step) == 1


def test_train_step_matches_jax_easy():
    """tests/test_ppo.py's easy config, 2 scenes, unroll 4, 2 epochs x 2
    minibatches.  The policy forward differs from flax by ~1e-7, which the
    kinematics carry: actions, log-probs and values within 1e-5, rewards
    (200 * step_ds) within 1e-3, poses within 1e-5, metrics within rtol
    1e-5, parameters within 1e-6 (they move by ~5e-3)."""
    check_step(step_pair("easy"), dict(act=1e-5, logp=1e-5, value=1e-5,
                                       reward=1e-3, pose=1e-5,
                                       metrics=1e-5, params=1e-6))


def test_gradient_clipping_bounds_update():
    """The port of tests/test_ppo.py's test: clip_by_global_norm(1e-3) +
    sgd(1), 1 epoch of 1 minibatch: the parameter step's global norm is at
    most 1.01 x the clip."""
    clip = 1e-3
    cfg, model = _port_model(EASY)
    env = BatchedNavEnv(cfg, "cpu", seed=1)
    gen = torch.Generator().manual_seed(0)
    _, params = tpolicy.init_policy(gen, model.cfg, "cpu")
    init_fn, train_step = ppo.make_train_step(
        env, model, ppo.PpoConfig(unroll=4, epochs=1, minibatches=1),
        tx=optim.chain(optim.clip_by_global_norm(clip), optim.sgd(1.0)))
    ts = init_fn(params)
    states, obs = env.reset(2)
    ts2, *_ = train_step(ts, states, obs, gen.manual_seed(2))
    sq = sum(float(((ts2.params[k] - params[k]) ** 2).sum())
             for k in params)
    assert 0 < math.sqrt(sq) <= clip * 1.01
    assert int(ts2.step) == 1


def test_init_policy_matches_flax_defaults():
    """``init_policy``: the state dict loads a converted flax init strictly
    (same names and shapes); each kernel's std is lecun's sqrt(1/fan_in)
    within 5 sampling sigmas and within the +-2 sigma truncation; biases
    zero; log_std the constant ``log_std_init``."""
    _, _, params, _ = _jax_parts("sfm")
    cfg, _ = _port_model(SFM)
    pcfg = tpolicy.PolicyConfig.from_env_config(cfg)
    pol, p = tpolicy.init_policy(torch.Generator().manual_seed(3), pcfg,
                                 "cpu")
    flax_sd = _to_port(params)
    assert list(p) == list(pol.state_dict())
    pol.load_state_dict(flax_sd, strict=True)      # shapes and names agree
    fan_in = {"sensor_trunk.convs.0.weight": 9, "ped_trunk.convs.0.weight":
              27, "sensor_trunk.proj.weight": 2304, "vec0.weight": 3,
              "crowd_attn.embed.weight": 7, "crowd_attn.out.weight": 64,
              "crowd_attn.query.weight": 64, "fuse0.weight": 512}
    for k, v in p.items():
        if k == "pi_log_std":
            assert torch.equal(v, torch.full_like(v, pcfg.log_std_init))
        elif k.endswith(".bias"):
            assert not bool(v.any()), k
        else:
            fi = v[0].numel()
            assert fi == fan_in.get(k, fi), k
            std = math.sqrt(1.0 / fi)
            n = v.numel()
            # the sample std of a +-2-sigma truncated normal: relative
            # spread sqrt((kurtosis - 1) / 4n), kurtosis 2.36
            assert abs(float(v.std()) / std - 1) < 5 * math.sqrt(
                1.36 / (4 * n)), k
            assert abs(float(v.mean())) < 5 * std / math.sqrt(n), k
            assert float(v.abs().max()) <= 2 * std / 0.87962566 * (1 + 1e-6)
            # flax's own draw of the same kernel has the same spread
            assert abs(float(flax_sd[k].std()) / std - 1) < 5 * math.sqrt(
                1.36 / (4 * n)), k
    # fresh draws per seed
    _, p2 = tpolicy.init_policy(torch.Generator().manual_seed(4), pcfg,
                                "cpu")
    assert not torch.equal(p["fuse0.weight"], p2["fuse0.weight"])
    inputs = tpolicy.example_inputs(pcfg, 3, "cpu")
    mean, log_std, value = pol(*inputs)
    assert mean.shape == (3, 2) and value.shape == (3,)


def test_checkpoint_round_trip(tmp_path):
    """A TrainState (parameters, Adam state, step), a WorldState and a
    generator's state survive ``save`` -> ``restore(like=...)`` equal; without
    ``like`` the tree comes back as dicts; ``load_ckpt_policy`` loads a
    params checkpoint to the same clipped mean actions; ``save_every``
    writes on interval boundaries only."""
    cfg, model = _port_model(SFM)
    env = BatchedNavEnv(cfg, "cpu")
    gen = torch.Generator().manual_seed(5)
    _, params = tpolicy.init_policy(gen, model.cfg, "cpu")
    init_fn, train_step = ppo.make_train_step(
        env, model, ppo.PpoConfig(unroll=2, epochs=1, minibatches=2))
    states, obs = env.reset(2)
    ts, states, obs, _ = train_step(init_fn(params), states, obs, gen)
    tree = {"ts": ts, "world": states, "rng": gen.get_state()}
    path = str(tmp_path / "ck" / "train.pt")
    checkpoint.save(path, tree)
    back = checkpoint.restore(path, like=tree, device="cpu")
    assert type(back["ts"]) is ppo.TrainState
    flat = lambda t: [x for x in jax.tree_util.tree_leaves(
        t, is_leaf=torch.is_tensor) if torch.is_tensor(x)]
    for a, b in zip(flat(back), flat(tree), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(back["ts"].opt_state[1][0].count) == 2
    raw = checkpoint.restore(path, device="cpu")
    assert set(raw["ts"]) == {"params", "opt_state", "step"}
    assert set(raw["world"]["robots"]) == set(states.robots._fields)
    with pytest.raises(ValueError):
        checkpoint.restore(path, like={"ts": ts, "world": states},
                           device="cpu")

    ppath = str(tmp_path / "params.pt")
    checkpoint.save(ppath, {"params": ts.params})
    fn, pol = tpolicy.load_ckpt_policy(cfg, ppath, "cpu")
    for k, v in pol.state_dict().items():
        assert torch.equal(v, ts.params[k]), k
    got = fn(None, obs)
    assert got.shape == (2, cfg.robot.total, 2)
    assert bool(torch.isfinite(got).all())
    assert not checkpoint.save_every(3, 2, str(tmp_path / "e"), tree)
    assert checkpoint.save_every(4, 2, str(tmp_path / "e"), tree)
    assert os.path.exists(str(tmp_path / "e-4"))


def test_warm_start_from_npz_equals_load_policy_npz():
    """``train.run``'s ``--restore`` of the committed stage-5 npz gives the
    parameters ``load_policy_npz`` loads, and ``load_ckpt_policy`` reads the
    npz too."""
    with open(os.path.join(ARTIFACTS, "stage5_policy_env.json")) as f:
        cfg = EnvConfig.from_dict(json.load(f))
    npz = os.path.join(ARTIFACTS, "stage5_policy.npz")
    pcfg = tpolicy.PolicyConfig.from_env_config(cfg)
    _, params = tpolicy.init_policy(torch.Generator().manual_seed(0), pcfg,
                                    "cpu")
    got = run.restore_params(npz, params)
    want = tpolicy.load_policy_npz(npz, cfg, "cpu").state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _, pol = tpolicy.load_ckpt_policy(cfg, npz, "cpu")
    assert torch.equal(pol.pi_log_std, want["pi_log_std"])


def test_run_entry_point_trains_saves_and_restores(tmp_path, capsys):
    """``python -m img_env_tpu_torch.train.run`` on a .json config on the
    CPU: the periodic line, the curve CSV and a checkpoint that the next
    run's ``--restore`` (with ``--force-sigma``) reads."""
    cfg_path = str(tmp_path / "easy.json")
    with open(cfg_path, "w") as f:
        json.dump(EASY, f)
    common = [cfg_path, "--device", "cpu", "--scenes", "2", "--unroll",
              "3", "--updates", "2", "--reward-scale", "0.02"]
    run.main(common + ["--save", str(tmp_path / "p.pt"),
                       "--curve", str(tmp_path / "c")])
    out = capsys.readouterr().out
    assert "update    1" in out and "robot-steps/s" in out and "done" in out
    curve = np.loadtxt(str(tmp_path / "c.csv"), delimiter=",", skiprows=1)
    assert curve.shape == (2, 4) and np.isfinite(curve).all()
    args = run.parse_args(common + ["--restore", str(tmp_path / "p.pt"),
                                    "--force-sigma", "-2.0", "--updates",
                                    "1"])
    res = run.train(args, log=lambda s: None)
    # warm-started, sigma forced, then 4 Adam steps of at most ~lr each
    log_std = res["ts"].params["pi_log_std"]
    assert float((log_std + 2.0).abs().max()) < 0.01
    saved = checkpoint.restore(str(tmp_path / "p.pt"), device="cpu")
    drift = float((res["ts"].params["fuse0.weight"]
                   - saved["params"]["fuse0.weight"]).abs().max())
    assert 0 < drift < 0.01
    assert set(res["timings"][0]) == {"rollout", "autoreset", "update"}


def test_discrete_head_is_not_trained():
    """The JAX loss reads a Gaussian head; the port's trainer refuses a
    discrete one rather than train it wrongly."""
    d = dict(EASY, discrete_action=True,
             discrete_actions=[[0.0, 0.0], [0.3, 0.0], [0.3, 0.5]])
    cfg, model = _port_model(d)
    assert model.cfg.discrete_actions == 3
    with pytest.raises(NotImplementedError):
        ppo.make_train_step(BatchedNavEnv(cfg, "cpu"), model)
