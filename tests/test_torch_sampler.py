"""The torch port's scenario sampler vs the JAX sampler.

torch cannot reproduce the JAX package's threefry draws, so the port's own
draws are held to the JAX sampler's marginals with two-sample KS tests, as
tests/test_sampler_distribution.py holds the JAX sampler to the reference:
D < 0.06 per coordinate at 2000 samples each (D_crit(alpha=1e-3) = 0.062).
The placement itself (circle, circle_fix and view pose types) is held
pose for pose by feeding ``sampler.place`` the JAX sampler's own draws.
"""

import jax
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.env.sampler import SamplerSpec as JaxSpec
from img_env_tpu.env.sampler import sample_scenario as jax_sample_once
from img_env_tpu.env.sampler import sample_scenario_retry as jax_sample
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.env.sampler import (
    SamplerDraws,
    SamplerSpec,
    draw,
    place,
    sample_scenario,
    sample_scenario_retry,
)

N_SAMPLES = 2000
D_MAX = 0.06


def _cfg_dict(n, obstacles):
    box = [1.5, 8.5, 1.5, 8.5]
    return {
        "robot": dict(total=n, shape=["circle"], size=[[0.0, 0.0, 0.17]],
                      begin_poses_type=["range"] * n, begin_poses=[box] * n,
                      target_poses_type=["range"] * n,
                      target_poses=[box] * n),
        "ped_sim": {"total": 0, "type": ""},
        "object": obstacles,
        "global_map": {"map_file": "room_10.png", "resolution": 0.1},
        "target_min_dist": 3.0,
        "reset_trials": 256,
        "reset_redraws": 10,
    }


CELLS = {
    "fix_obstacles": dict(total=2, shape=["circle", "circle"],
                          size_range=[[0.25, 0.25], [0.35, 0.35]],
                          poses_type=["fix", "fix"],
                          poses=[[4.0, 4.0, 0.0], [6.5, 6.0, 0.0]]),
    "range_obstacles": dict(total=3, shape=["circle", "rectangle", "circle"],
                            size_range=[[0.2, 0.4], [-0.2, 0.2, -0.1, 0.1],
                                        [0.1, 0.3]],
                            poses_type=["range"] * 3,
                            poses=[[2.0, 8.0, 2.0, 8.0]] * 3),
}


def _ours(d, seed=0):
    spec = SamplerSpec.from_config(EnvConfig.from_dict(d))
    g = torch.Generator().manual_seed(seed)
    samples = [sample_scenario_retry(spec, g) for _ in range(N_SAMPLES)]
    assert all(bool(s.ok) for s in samples)
    stack = lambda f: torch.stack([getattr(s, f) for s in samples]).numpy()
    return {f: stack(f) for f in ("init_poses", "target_poses", "obs_pose",
                                  "obs_circle_r")}


def _theirs(d, seed=0):
    spec = JaxSpec.from_config(JaxEnvConfig.from_dict(d))
    keys = jax.random.split(jax.random.PRNGKey(seed), N_SAMPLES)
    with jax.enable_x64(False):
        s = jax.jit(jax.vmap(lambda k: jax_sample(k, spec)))(keys)
    assert bool(np.asarray(s.ok).all())
    return {f: np.asarray(getattr(s, f)) for f in (
        "init_poses", "target_poses", "obs_pose", "obs_circle_r")}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_range_marginals_match_jax(cell):
    d = _cfg_dict(3, CELLS[cell])
    ours, theirs = _ours(d), _theirs(d)
    for f in ("init_poses", "target_poses", "obs_pose"):
        for i in range(ours[f].shape[1]):
            for c in range(3):
                a, b = ours[f][:, i, c], theirs[f][:, i, c]
                if np.ptp(b) == 0:           # fixed coordinate
                    np.testing.assert_array_equal(a, b)
                    continue
                dks, p = ks_2samp(a, b)
                assert dks < D_MAX, f"{f}[{i},{c}] KS D={dks:.4f} p={p:.2g}"
    for i in range(ours["obs_circle_r"].shape[1]):
        a, b = ours["obs_circle_r"][:, i], theirs["obs_circle_r"][:, i]
        if np.ptp(b) == 0:
            np.testing.assert_allclose(a, b)
        else:
            assert ks_2samp(a, b)[0] < D_MAX
    gd = np.linalg.norm(ours["target_poses"][..., :2]
                        - ours["init_poses"][..., :2], axis=-1)
    assert gd.min() > 3.0
    starts = ours["init_poses"][..., :2]
    sep = np.linalg.norm(starts[:, :, None] - starts[:, None], axis=-1)
    assert (sep + 10 * np.eye(3) > 1.0).all()


def _pose_cfg_dict():
    """One agent per pose type of the circle and view families: robots on
    range_circle, range_circle_fix and range -> range_view, a ped on
    range_circle_fix -> circle_fix; two obstacles to clear."""
    circ = [5.0, 5.0]
    d = _cfg_dict(3, dict(total=2, shape=["circle", "rectangle"],
                          size_range=[[0.2, 0.3], [-0.2, 0.2, -0.1, 0.1]],
                          poses_type=["range"] * 2,
                          poses=[[2.0, 8.0, 2.0, 8.0]] * 2))
    d["robot"].update(
        begin_poses_type=["range_circle", "range_circle_fix", "range"],
        begin_poses=[circ, circ, [2.0, 8.0, 2.0, 8.0]],
        target_poses_type=["range_circle", "range_circle_fix", "range_view"],
        target_poses=[circ, circ, [1.0, 9.0, 1.0, 9.0]])
    d["ped_sim"] = dict(total=1, type="pedscene", shape=["circle"],
                        size=[[0.0, 0.0, 0.17]], max_speed=[0.5],
                        begin_poses_type=["range_circle_fix"],
                        begin_poses=[circ], target_poses_type=["circle_fix"],
                        target_poses=[circ], go_back="random")
    d["circle_ranges"] = [2.5, 3.5]
    d["target_min_dist"] = 1.0
    return d


def _jax_draws(key, spec):
    """The draws of the JAX package's sample_scenario (sampler.py:304-428)
    under ``key``, float32, in the port's SamplerDraws layout."""
    o, a = len(spec.obs_type), len(spec.begin_type)
    t, m = spec.trials, spec.n_peds
    rnd = jax.random
    k_obs, k_cr, k_agents, k_gb = rnd.split(key, 4)
    kf = rnd.split(k_agents, a + 1)

    def propose(k, nreg):
        ks = rnd.split(k, 4)
        return (rnd.uniform(ks[0], (t, 3)), rnd.normal(ks[1], (t, 2)) * 0.5,
                rnd.randint(ks[2], (t,), 0, nreg))

    def agent(k, nb, nt):
        k_b, k_t = rnd.split(k)
        ub, gb, rb = propose(k_b, nb)
        ut, _, rt = propose(k_t, nt)
        gt = rnd.normal(rnd.fold_in(k_t, 7), (t, 2)) * 0.5
        return ub, rb, ut, rt, gb, gt

    with jax.enable_x64(False):
        ub, rb, ut, rt, gb, gt = jax.jit(jax.vmap(agent))(
            kf[:a], np.asarray(spec.begin_nreg, np.int32),
            np.asarray(spec.target_nreg, np.int32))
        lo, hi = spec.circle_ranges
        cr = rnd.uniform(k_cr, (), minval=lo, maxval=hi)
        parts = (rnd.uniform(k_obs, (o, 4)), rnd.uniform(kf[a], (a,)), ub,
                 rb, ut, rt, cr, gb, gt, rnd.uniform(k_gb, (m,)))
    t_ = lambda x: torch.as_tensor(np.array(x))
    return SamplerDraws(*(t_(x) for x in parts))._replace(
        begin_region=t_(rb).long(), target_region=t_(rt).long())


@pytest.mark.parametrize("seed", range(4))
def test_circle_and_view_pose_types_with_jax_draws(seed):
    """The port's placement fed the JAX sampler's own draws gives the JAX
    layout bit for bit (glibc's sin/cos, XLA's contractions and its folding
    of angle + 3.14 into the uniform's product), the picks, go-back flags
    and ok exactly.  The one exception is the x, y of a Gaussian-noised
    circle pose (range_circle, range_circle_fix: robots 0 and 1, and the
    ped's start), held within one float32 ulp: inside the jitted sampler
    XLA folds the noise's scale into its last add, so the scaled draw
    handed to the port is an ulp from the value the JAX sum used."""
    d = _pose_cfg_dict()
    spec_j = JaxSpec.from_config(JaxEnvConfig.from_dict(d))
    spec_t = SamplerSpec.from_config(EnvConfig.from_dict(d))
    key = jax.random.PRNGKey(seed)
    with jax.enable_x64(False):
        want = jax.jit(lambda k: jax_sample_once(k, spec_j))(key)
    got = place(spec_t, _jax_draws(key, spec_j))
    assert bool(got.ok) == bool(want.ok)
    noisy = {"init_poses": [0, 1, 3], "target_poses": [0, 1]}
    for f in ("init_poses", "target_poses", "obs_pose", "obs_circle_r"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        exact = np.ones(g.shape, bool)
        if f in noisy:
            exact[noisy[f], :2] = False
        np.testing.assert_array_equal(g[exact], w[exact], err_msg=f)
        np.testing.assert_array_max_ulp(g[~exact], w[~exact], maxulp=1)
    np.testing.assert_array_equal(got.go_back.numpy(),
                                  np.asarray(want.go_back))
    # the circle_fix goal is the exact opposite of the start
    i, cr = 3, float(_jax_draws(key, spec_j).circle_range)
    start, goal = got.init_poses[i].numpy(), got.target_poses[i].numpy()
    np.testing.assert_allclose(goal[:2], [5.0 + cr * np.cos(start[2]),
                                          5.0 + cr * np.sin(start[2])],
                               atol=1e-5)


def test_circle_and_view_marginals_match_jax():
    """The port's own draws against the JAX sampler's, by distribution:
    KS per coordinate, 24 coordinates at 2000 samples each.  The bound is
    D_crit for alpha = 1e-3 over the family (Bonferroni, 4.2e-5 per
    coordinate): 0.073 (two JAX seeds against each other reach 0.052)."""
    d = _pose_cfg_dict()
    ours, theirs = _ours(d), _theirs(d)
    for f in ("init_poses", "target_poses"):
        for i in range(ours[f].shape[1]):
            for c in range(3):
                a, b = ours[f][:, i, c], theirs[f][:, i, c]
                dks, p = ks_2samp(a, b)
                assert dks < 0.073, f"{f}[{i},{c}] KS D={dks:.4f} p={p:.2g}"
    # range_view goals: outside the start's 5 m box, inside the region
    gap = np.abs(ours["target_poses"][:, 2, :2] - ours["init_poses"][:, 2, :2])
    assert (gap.max(axis=1) > 2.5).all()
    assert ((ours["target_poses"][:, 2, :2] >= 1.0)
            & (ours["target_poses"][:, 2, :2] <= 9.0)).all()


def test_draws_follow_the_generator_device():
    """Without a device argument the draws and the scenario lie on the
    generator's device and equal those of an explicit device argument
    (tests/test_torch_cuda_kernels.py holds the same on a CUDA
    generator)."""
    spec = SamplerSpec.from_config(EnvConfig.from_dict(
        _cfg_dict(3, CELLS["range_obstacles"])))
    g = torch.Generator().manual_seed(3)
    ref = torch.Generator().manual_seed(3)
    for got, want in ((draw(spec, g), draw(spec, ref, "cpu")),
                      (sample_scenario(spec, g),
                       sample_scenario(spec, ref, "cpu")),
                      (sample_scenario_retry(spec, g),
                       sample_scenario_retry(spec, ref, "cpu"))):
        for a, b in zip(got, want):
            assert a.device == g.device
            assert torch.equal(a, b)
