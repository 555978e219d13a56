"""The port's ``CrowdNavPolicy`` forward against flax ``apply`` at full
width, with both committed checkpoints converted from orbax (stage 5,
act_dim 2; ERVO, act_dim 3) and a freshly initialised discrete head; the
committed npz against the orbax restore; ``sample_action`` with injected
draws.

The flax side is jitted under ``jax.enable_x64(False)``; both run float32
on the CPU, where the convolutions and matmuls sum in different orders:
rtol 1e-5 / atol 1e-5.  Observations include robots that see no ped (the
masked attention must stay finite there) and robots that see
``max_ped``.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_env  # noqa: F401  (one torch thread per worker)
from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.config import read_yaml
from img_env_tpu.core.state import Observation as JaxObservation
from img_env_tpu.models import policy as jpolicy
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.core.state import Observation
from img_env_tpu_torch.models import policy as tpolicy
from tools.export_policy_npz import flat_params, restore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "img_env_tpu", "configs")
ARTIFACTS = os.path.join(REPO, "img_env_tpu_torch", "artifacts")
CKPTS = {
    "stage5": ("docs/artifacts/baseline_curriculum/stage5_ckpt",
               "baseline_10obs_5ped.yaml", None),
    "ervo": ("docs/artifacts/ervo/ckpt", "ervo_crowd.yaml", 3),
}
TOL = dict(rtol=1e-5, atol=1e-5)
B = 8


@functools.lru_cache(maxsize=None)
def _checkpoint(name):
    """(raw env config, flat float32 flax parameters) of a committed
    checkpoint, restored from orbax."""
    ckpt, yaml_name, act_dim = CKPTS[name]
    raw = read_yaml(os.path.join(CONFIGS, yaml_name))
    if act_dim is not None:
        raw["act_dim"] = act_dim
    with jax.enable_x64(False):
        flat = flat_params(restore(os.path.join(REPO, ckpt), raw))
    return raw, flat


def _nest(flat):
    tree = {}
    for k, v in flat.items():
        d = tree
        parts = k.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = jnp.asarray(v)
    return tree


def observations(cfg, seed=0, b=B):
    """Seeded policy inputs: sparse ped maps, and ped counts 0 (rows 0-1),
    partial, ``max_ped`` and above it."""
    rng = np.random.default_rng(seed)
    h, w = cfg.image_size
    sm = rng.uniform(0, 1, (b, 1, h, w)).astype(np.float32)
    vs = rng.normal(0, 2, (b, cfg.state_dim)).astype(np.float32)
    pm = ((rng.uniform(size=(b, 3, h, w)) > 0.9)
          * rng.normal(0, 1, (b, 3, h, w))).astype(np.float32)
    pv = rng.normal(0, 1, (b, 1 + cfg.ped_vec_dim * cfg.max_ped))
    pv[:, 0] = rng.integers(0, cfg.max_ped + 3, b)
    pv[:4, 0] = (0, 0, cfg.max_ped, 1)
    return sm, vs, pm, pv.astype(np.float32)


def _forwards(raw, flat, inputs):
    jcfg = jpolicy.PolicyConfig.from_env_config(JaxEnvConfig.from_dict(raw))
    with jax.enable_x64(False):
        want = jax.jit(jpolicy.CrowdNavPolicy(jcfg).apply)(
            {"params": _nest(flat)["params"]}, *map(jnp.asarray, inputs))
    pol = tpolicy.CrowdNavPolicy(
        tpolicy.PolicyConfig.from_env_config(EnvConfig.from_dict(raw)))
    pol.load_state_dict(tpolicy.policy_params_from_numpy(flat), strict=True)
    with torch.no_grad():
        got = pol(*map(torch.as_tensor, inputs))
    return got, want


@pytest.mark.parametrize("name", sorted(CKPTS))
def test_checkpoint_forward_matches_flax(name):
    raw, flat = _checkpoint(name)
    cfg = EnvConfig.from_dict(raw)
    got, want = _forwards(raw, flat, observations(cfg))
    assert len(got) == 3
    assert got[0].shape == (B, cfg.act_dim)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


def test_fresh_discrete_head_matches_flax():
    """A discrete config (test.yaml's action table, no peds) initialised by
    flax, converted, and run through both."""
    raw = read_yaml(os.path.join(CONFIGS, "test.yaml"))
    raw["ped_sim"] = {"total": 0, "type": ""}
    jcfg = jpolicy.PolicyConfig.from_env_config(JaxEnvConfig.from_dict(raw))
    assert jcfg.discrete_actions > 0
    with jax.enable_x64(False):
        _, params = jpolicy.init_policy(jax.random.PRNGKey(3), jcfg, batch=2)
    flat = flat_params(params)
    cfg = EnvConfig.from_dict(raw)
    sm, vs, pm, pv = observations(cfg, seed=1)
    got, want = _forwards(raw, flat, (sm, vs))
    assert len(got) == 2 and got[0].shape == (B, jcfg.discrete_actions)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


def test_committed_npz_equals_orbax_restore():
    """``img_env_tpu_torch/artifacts/stage5_policy.npz`` holds the stage-5
    checkpoint's leaves exactly, and its env json is the yaml's dict."""
    raw, flat = _checkpoint("stage5")
    with np.load(os.path.join(ARTIFACTS, "stage5_policy.npz")) as z:
        assert sorted(z.files) == sorted(flat)
        for k in flat:
            assert z[k].dtype == np.float32
            np.testing.assert_array_equal(z[k], flat[k], err_msg=k)
    with open(os.path.join(ARTIFACTS, "stage5_policy_env.json")) as f:
        assert json.load(f) == json.loads(json.dumps(raw))


def test_load_policy_npz_and_mean_action_fn():
    """``load_policy_npz`` + ``mean_action_fn`` on raw observations with
    [S, N] leading axes against the JAX loader's clipped mean."""
    raw, flat = _checkpoint("stage5")
    cfg = EnvConfig.from_dict(raw)
    pol = tpolicy.load_policy_npz(os.path.join(ARTIFACTS,
                                               "stage5_policy.npz"),
                                  cfg, "cpu")
    assert not pol.training
    sm, vs, pm, pv = observations(cfg, seed=2)
    fields = dict(vector_states=vs, sensor_maps=sm[:, 0], ped_maps=pm,
                  ped_vector_states=pv)
    fn = tpolicy.mean_action_fn(pol, cfg)
    got = fn(None, Observation(**{k: torch.as_tensor(v).reshape(
        (2, B // 2) + v.shape[1:]) for k, v in fields.items()},
        is_collisions=None, is_arrives=None, lasers=None, step_ds=None,
        ped_min_dists=None))
    assert got.shape == (2, B // 2, 2)
    ckpt = os.path.join(REPO, CKPTS["stage5"][0])
    with jax.enable_x64(False):
        pf, params = jpolicy.load_ckpt_policy(JaxEnvConfig.from_dict(raw),
                                              ckpt, B)
        want = pf(params, JaxObservation(
            **{k: jnp.asarray(v) for k, v in fields.items()},
            is_collisions=None, is_arrives=None, lasers=None, step_ds=None,
            ped_min_dists=None))
    np.testing.assert_allclose(got.reshape(B, 2).numpy(), np.asarray(want),
                               **TOL)


def test_sample_action_with_injected_draws():
    """Gaussian and categorical draws: the JAX key's standard-normal and
    Gumbel draws injected into the port give JAX's actions and log-probs."""
    rng = np.random.default_rng(4)
    mean = rng.normal(0, 1, (B, 2)).astype(np.float32)
    log_std = np.full((B, 2), -0.5, np.float32)
    value = rng.normal(0, 1, B).astype(np.float32)
    logits = rng.normal(0, 2, (B, 5)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ranges = [(0.0, 0.6), (-0.9, 0.9)]
    with jax.enable_x64(False):
        eps = jax.random.normal(key, mean.shape)
        gum = jax.random.gumbel(key, logits.shape)
        want_c = jpolicy.sample_action(
            key, tuple(map(jnp.asarray, (mean, log_std, value))), ranges)
        want_d = jpolicy.sample_action(
            key, tuple(map(jnp.asarray, (logits, value))))
    got_c = tpolicy.sample_action(
        tuple(map(torch.as_tensor, (mean, log_std, value))),
        draws=torch.as_tensor(np.array(eps)), continuous_ranges=ranges)
    got_d = tpolicy.sample_action(
        tuple(map(torch.as_tensor, (logits, value))),
        draws=torch.as_tensor(np.array(gum)))
    for g, w in zip(got_c, want_c):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(got_d[0].numpy(), np.asarray(want_d[0]))
    np.testing.assert_allclose(got_d[1].numpy(), np.asarray(want_d[1]),
                               rtol=1e-6, atol=1e-6)
    # the port's own draws: finite, in range, from a seeded generator
    gen = torch.Generator().manual_seed(0)
    act, logp, _ = tpolicy.sample_action(
        tuple(map(torch.as_tensor, (mean, log_std, value))), gen,
        continuous_ranges=ranges)
    assert bool(torch.isfinite(logp).all())
    assert float(act[:, 0].min()) >= 0.0
    assert float(act[:, 0].max()) <= np.float32(0.6)
