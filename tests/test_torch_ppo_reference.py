"""The port's PPO update (``img_env_tpu_torch.train``) against the
benchmark's plain reference (``navbench/reference/train``) on the CPU,
with seeded random weights from ``init_policy`` on the small SFM config of
``tests/test_torch_trace.py``: GAE, the loss terms, every gradient leaf
under the trainer's error model, three clip + Adam steps, and one whole
``train_step`` with injected ``Draws`` replayed by the ``stage5.train32``
cell's ``Reference`` number by number (S=2, T=4, 2 x 2 minibatches).
Also: the reference imports neither JAX nor the program, and
``navbench.trainflops`` counts what ``FlopCounterMode`` counts.  Imports
nothing of JAX."""

import json
import os
import subprocess
import sys

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.models.policy import (PolicyConfig, init_policy,
                                             sample_action)
from img_env_tpu_torch.parallel import BatchedNavEnv
from img_env_tpu_torch.train import optim, ppo
from navbench import check, run, trainflops
from navbench.parts import load_part
from navbench.reference.models import policy as ref_policy
from navbench.reference.train import optim as ref_optim
from navbench.reference.train import ppo as ref_ppo
from tests.test_torch_trace import CFG

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAVBENCH = os.path.join(REPO, "navbench")
S, T = 2, 4
PPO = ppo.PpoConfig(unroll=T, epochs=2, minibatches=2, lr=3e-5,
                    ent_coef=0.0005, reward_scale=0.02)
SETTINGS = ref_ppo.Settings(**{k: getattr(PPO, k)
                               for k in ref_ppo.Settings._fields})


def env_cfg(time_max: int = 100):
    return EnvConfig.from_dict(dict(CFG, time_max=time_max))


def policies():
    """The port's policy with seeded random weights, the reference's
    module of the same configuration."""
    cfg = env_cfg()
    model, params = init_policy(torch.Generator().manual_seed(3),
                                PolicyConfig.from_env_config(cfg), "cpu")
    params["pi_log_std"] = torch.full_like(params["pi_log_std"], -2.0)
    ref = ref_policy.CrowdNavPolicy(
        ref_policy.PolicyConfig.from_env_config(cfg))
    return model, ref, params


def minibatch(model, params, b: int = 8):
    """A minibatch of ``b`` samples: observations of reset scenes (2
    robots a scene), actions drawn by the policy, old log-probabilities
    near theirs, advantages and returns from a seed."""
    env = BatchedNavEnv(env_cfg(), "cpu", seed=4)
    _, obs = env.reset(b // 2)
    feats = ppo.obs_features(obs, True)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        out = torch.func.functional_call(model, params, feats)
    act, logp, _ = sample_action(out, g)
    return (feats, act, logp + 0.05 * torch.randn(b, generator=g),
            torch.randn(b, generator=g), torch.randn(b, generator=g))


def test_gae_equals_reference():
    g = torch.Generator().manual_seed(1)
    values, rewards = (torch.randn(T, 6, generator=g) for _ in range(2))
    dones = (torch.rand(T, 6, generator=g) < 0.3).to(torch.int32)
    last = torch.randn(6, generator=g)
    want = ref_ppo.gae(values, rewards, dones, last, 0.99, 0.95)
    assert torch.equal(ppo.gae(values, rewards, dones, last, 0.99, 0.95),
                       want)
    assert not torch.equal(want, ref_ppo.gae(values, rewards,
                                             torch.zeros_like(dones), last,
                                             0.99, 0.95))


def test_loss_terms_equal_reference():
    g = torch.Generator().manual_seed(2)
    mean, act = torch.randn(16, 2, generator=g), torch.randn(16, 2,
                                                            generator=g)
    log_std = torch.full((16, 2), -2.0)
    value, logp_old, returns = (torch.randn(16, generator=g)
                                for _ in range(3))
    advs = 3.0 * torch.randn(16, generator=g) + 1.0
    got_advs, got_n = ppo.normalise_advantages(advs)
    want_advs, want_n = ref_ppo.normalise(advs)
    assert torch.equal(got_advs, want_advs) and float(got_n) == 16
    got = ppo.loss_terms((mean, log_std, value), act, logp_old, want_advs,
                         returns, PPO)
    want = ref_ppo.loss_terms((mean, log_std, value), act, logp_old,
                              want_advs, returns, PPO.clip)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # some ratios are clipped
    ratio = torch.exp(((-0.5 * ((act - mean) / torch.exp(log_std)) ** 2
                        - log_std - 0.5 * ref_ppo._LOG_2PI).sum(-1))
                      - logp_old)
    assert ((ratio - 1).abs() > PPO.clip).any()


def test_every_gradient_leaf_within_error_model():
    model, ref, params = policies()
    mb = minibatch(model, params)
    loss, aux, grads = ppo.loss_and_grads(model, params, mb, PPO)
    terms, want = ref_ppo.loss_and_grads(ref, params, mb, SETTINGS)
    assert torch.allclose(torch.stack([loss, aux["pg_loss"], aux["vf_loss"],
                                       aux["entropy"]]), terms,
                          rtol=1e-6, atol=1e-7)
    sums = ref_ppo.term_sums(ref, params, mb, SETTINGS, chunk=3)
    ratios = ppo.grad_error_ratios(grads, want, sums)
    assert set(ratios) == set(params)
    assert max(ratios.values()) <= 1.0, ratios
    # the reference's per-sample sums (torch.func) give the trainer's own
    # (a loop over the samples) tolerance, leaf by leaf, and its sums
    # element by element where they are more than rounding noise (the key
    # bias's terms are)
    loop = ppo.grad_term_sums(model, params, mb, PPO)
    tol = lambda x: ppo.GRAD_REL * float(x.max()) + ppo.GRAD_ABS
    for k, v in loop.items():
        assert abs(tol(sums[k]) - tol(v)) <= 1e-4 * tol(v), k
        if float(v.max()) > 1e3 * ppo.GRAD_ABS:
            gap = float((sums[k] - v).abs().max())
            assert gap <= 1e-5 * float(v.max()), k
    assert float(sums["sensor_trunk.convs.0.weight"].max()) > 0


def test_three_clip_and_adam_steps_equal_reference():
    g = torch.Generator().manual_seed(6)
    _, _, params = policies()
    tx = optim.chain(optim.clip_by_global_norm(PPO.max_grad_norm),
                     optim.adam(PPO.lr))
    state = tx.init(params)
    p_ref = dict(params)
    s_ref = ref_optim.Adam(torch.zeros((), dtype=torch.int32),
                           {k: torch.zeros_like(v) for k, v in params.items()},
                           {k: torch.zeros_like(v) for k, v in params.items()})
    clipped = []
    for scale in (1e-4, 1.0, 10.0):
        grads = {k: scale * torch.randn(v.shape, generator=g)
                 for k, v in params.items()}
        updates, state = tx.update(grads, state, params)
        params = optim.apply_updates(params, updates)
        cg, factor = ref_optim.clip_by_global_norm(grads, PPO.max_grad_norm)
        clipped.append(float(factor) < 1)
        p_ref, s_ref = ref_optim.adam_step(p_ref, cg, s_ref, PPO.lr)
    assert clipped == [False, True, True]
    adam = state[1][0]
    assert int(adam.count) == int(s_ref.count) == 3
    for k in params:
        assert torch.equal(params[k], p_ref[k]), k
        assert torch.equal(adam.mu[k], s_ref.mu[k]), k
        assert torch.equal(adam.nu[k], s_ref.nu[k]), k


def test_train_step_replayed_by_the_cell_reference():
    """Three updates of the ``ppo`` loop (one warm-up, then S=2 scenes of
    the small SFM config for T=4 steps, 2 x 2 minibatches, finished scenes
    redrawn), two of them compared: every number of the cell's check reads
    0, the port and the reference being the same float32 operations on the
    CPU."""
    traffic = {"loop": "ppo", "actor": "gaussian", "scenes": S,
               "reads": ["metrics"], "autoreset": True, "episode_pool": 6,
               "ppo": {"unroll": T, "epochs": 2, "minibatches": 2,
                       "lr": 3e-5, "ent_coef": 0.0005, "reward_scale": 0.02,
                       "log_std": -2.0},
               "warmup_steps": 1, "trace_steps": 1,
               "check": {"count": 2, "within": 3}}
    config = {"env": dict(CFG, time_max=5)}
    started = not dist.is_initialized()
    try:
        loop = load_part(NAVBENCH, "loops", "ppo").Loop(
            run.program(), check.load_reference(), config, traffic,
            2 ** 31 + 9, "cpu", NAVBENCH)
        loop.setup()
        loop.warm_up()
        for _ in range(3):
            loop.step()
        loop.finish()
        loop.free()
        values = loop.reference().run()
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(NAVBENCH, "checks", "stage5.train32.json"),
              encoding="utf-8") as f:
        numbers = set(json.load(f)["limits"])
    assert set(values) == numbers
    assert all(v == 0.0 for v in values.values()), values
    assert len(loop.checks) == 2
    assert any(call["ids"] for r in loop.checks for call in r["resets"])
    assert all(len(r["steps"]) == T for r in loop.checks)
    # the parameters of each minibatch's gradient, the first the update's
    assert all(len(r["grad_params"]) == 2 * 2 for r in loop.checks)
    for r in loop.checks:
        first = r["grad_params"][0]
        assert all(torch.equal(first[k], v)
                   for k, v in r["ts"].params.items())


def test_reference_imports_neither_jax_nor_program():
    code = ("import json, sys\n"
            "import navbench.reference.train.ppo\n"
            "import navbench.reference.train.optim\n"
            "import navbench.trainflops\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    assert not set(json.loads(out)) & {"jax", "jaxlib", "flax",
                                       "img_env_tpu", "img_env_tpu_torch"}


def test_trainflops_equals_flop_counter():
    """The stage-5 policy's forward and backward at batch 4, the
    observation needing no gradient, as the update takes them."""
    with open(os.path.join(NAVBENCH, "configs", "stage5_train.json"),
              encoding="utf-8") as f:
        env = json.load(f)["env"]
    from navbench.reference.config import EnvConfig as RefEnvConfig

    cfg = ref_policy.PolicyConfig.from_env_config(
        RefEnvConfig.from_dict(env))
    model = ref_policy.CrowdNavPolicy(cfg)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in model.state_dict().items()}
    g = torch.Generator().manual_seed(0)
    b = 4
    ped = torch.rand(b, 1 + cfg.ped_vec_dim * cfg.max_ped, generator=g)
    ped[:, 0] = 3
    feats = (torch.rand(b, 1, 48, 48, generator=g),
             torch.rand(b, cfg.state_dim, generator=g),
             torch.rand(b, 3, 48, 48, generator=g), ped)
    with FlopCounterMode(display=False) as counter:
        out = torch.func.functional_call(model, params, feats)
        fwd = counter.get_total_flops()
        torch.autograd.grad(out[0].sum() + out[2].sum(),
                            list(params.values()), allow_unused=True)
    fwd_one, bwd_one = trainflops.sample_flops(cfg)
    assert fwd == b * fwd_one
    assert counter.get_total_flops() - fwd == b * bwd_one
    # one stage-5 update: 2 epochs over 512 samples and the last value
    # over 32, about 60 GFLOP
    assert trainflops.update_flops(cfg, 512, 2, 32) == \
        2 * 512 * (fwd_one + bwd_one) + 32 * fwd_one
    assert 55e9 < trainflops.update_flops(cfg, 512, 2, 32) < 65e9
