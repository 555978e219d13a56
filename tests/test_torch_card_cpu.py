"""The card against the port on the CPU (which ``tests/test_torch_*.py``
hold to the JAX package), float32 without TF32, and the serving paths on
the card:

* the small configs of ``card_common.py`` (plain, SFM, copies of the
  shipped test.yaml and ervo_crowd.yaml, and a replayed dataset) step by
  step from the CPU's states, each ending with a reset that carries the
  last state over; the small scene batches; the stage-5 policy's forward;
* the trusted evaluator over bank50 at full width (K1-K4 once a step, the
  arrive floor, a step and the policy without host syncs, K1-K4 bit-equal
  to their twins there) and the small evaluator config's facade episode
  and 3-episode evaluation, equal to the CPU's;
* the LQT passes, the small config's iLQR act and a CEM solve;
* BARN over generated worlds 0-99 x 3 episodes with the goal-field MPPI:
  its floors, K1-K3 once a step, the fields card = CPU bit for bit;
* the experiment matrix's ORCA cell and part C's cells (beep on and off),
  the renderers card = CPU, the indicator table without matplotlib; the
  hardware and external-simulator frontends card = CPU; the
  ``eval.evaluate --batch`` and ``examples.run_mpc --render`` entry
  points.

These need an NVIDIA GPU and nvcc and skip without them.  On the machine
with the card (which has no JAX) run them without the JAX test conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_kernels.py tests/test_torch_card_*.py

This file imports nothing of JAX.
"""

import contextlib
import copy
import io
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

import card_common as cc
from img_env_tpu_torch import (BatchedNavEnv, EnvConfig, MpcController,
                               MppiConfig, NavEnv, ScenarioBank,
                               evaluate_batched, load_policy_npz, make_env,
                               mean_action_fn)
from img_env_tpu_torch.core.convert import (world_state_from_numpy,
                                            world_state_to_numpy)
from img_env_tpu_torch.core.state import map_tree
from img_env_tpu_torch.mpc.controller import MpcState

pytestmark = pytest.mark.cuda

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def no_tf32(dev):
    """float32 without TF32, as the CPU computes it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.fixture(scope="module")
def stage5(dev):
    """The stage-5 policy on the card and its env config."""
    with open(cc.POLICY_ENV, encoding="utf-8") as f:
        cfg = EnvConfig.from_dict(json.load(f))
    return load_policy_npz(cc.POLICY_NPZ, cfg, dev), cfg


def bank50_reset(cfg, dev):
    """A batch of the stage-5 config reset to bank50's 50 episodes."""
    benv = BatchedNavEnv(cfg, dev)
    bank = ScenarioBank.load(cc.BANK50)
    spec = benv.core.statics.sampler
    states, obs = benv.reset([bank.sample(e, spec, benv.device)
                              for e in range(cc.EVAL_EPISODES)])
    return benv, states, obs


# ---- the small configs and batches ----

def synthetic_dataset(m: int, t: int, dt: float, seed: int = 0):
    """Seeded replay arrays (traj [m,t,2], vel [m,t,2], length [m]) of
    random walks inside the 10 m room, each series of its own length."""
    g = torch.Generator().manual_seed(seed)
    steps = (torch.rand((m, t, 2), generator=g) - 0.5) * 0.4
    traj = 3.0 + 4.0 * torch.rand((m, 1, 2), generator=g) + steps.cumsum(1)
    length = torch.randint(t // 2, t + 1, (m,), generator=g, dtype=torch.int32)
    return traj, steps / dt, length


SMALL_CONFIGS = {
    "small": (cc.SMALL, None),
    "small_crowd": (cc.SMALL_PED, None),
    "rvoscene": (cc.SMALL_RVO, None),
    "ervoscene": (cc.SMALL_ERVO, None),
    "dataset": (cc.SMALL_DATASET,
                synthetic_dataset(4, 24, cc.SMALL_DATASET["control_hz"])),
}


def small_reference(cfg_dict, device, dataset=None):
    """A small config on the card vs the same port on the CPU, from one
    layout, one noise draw and one beep draw per step.  Each step is
    observed from the CPU state on both devices (teacher forcing), so
    transcendental rounding cannot accumulate.  Sensor maps, lasers,
    collision and arrival codes must be equal, the actions within 1e-3.
    With peds, the ped maps, ped vectors and min distances must be equal,
    the gait phases too, and the crowd step within PED_TOL; the ORCA
    crowds' split segments must be equal.  The ERVO config's even robots
    beep, and some robot must beep.  It ends with a reset on both devices
    that carries the last CPU state over, whose ped states, commands and
    observations must be equal.  Returns the worst differences."""
    cfg = EnvConfig.from_dict(cfg_dict)
    peds = cfg.ped_sim.total > 0
    scene = cfg.ped_sim.type if peds else ""
    n = cfg.robot.total
    env_c, env_g = NavEnv(cfg, "cpu"), NavEnv(cfg, device)
    ctl_c = MpcController(env_c, MppiConfig(horizon=cc.H, samples=cc.K))
    ctl_g = MpcController(env_g, MppiConfig(horizon=cc.H, samples=cc.K))
    to_g = lambda s: world_state_from_numpy(world_state_to_numpy(s), device)
    sample = env_c.sample_scenario()
    st_c, obs_c = env_c.reset(sample, dataset=dataset)
    st_g, obs_g = env_g.reset(cc.to_device(sample, device), dataset=dataset)
    assert torch.equal(st_c.obs_map, st_g.obs_map.cpu())
    segs_c, segs_g = st_c.obstacles.segs, st_g.obstacles.segs
    if scene in ("rvoscene", "ervoscene"):
        assert segs_c is not None and segs_g is not None
    if segs_c is not None:
        assert all(torch.equal(a, b.cpu()) for a, b in zip(segs_c, segs_g))
    worst = {"actions": 0.0}
    if peds:
        worst.update(ped_pos=0.0, ped_vel=0.0, beeps=0)
    exact = ["sensor_maps", "lasers", "is_collisions", "is_arrives"]
    if peds:
        exact += ["ped_maps", "ped_vector_states", "ped_min_dists"]

    def check_obs(obs_c, obs_g):
        for f in exact:
            assert torch.equal(getattr(obs_c, f), getattr(obs_g, f).cpu()), f

    ms = ctl_c.init_state()
    for step in range(4):
        check_obs(obs_c, obs_g)
        if step == 3:
            break
        noise = ctl_c.draw_noise()
        a_c, ms_next, _ = ctl_c.act(st_c, ms, noise)
        a_g, _, _ = ctl_g.act(to_g(st_c), MpcState(ms.nominal.to(device)),
                              noise.to(device))
        worst["actions"] = max(worst["actions"],
                               float((a_c - a_g.cpu()).abs().max()))
        ms = ms_next
        if scene == "ervoscene":
            a_c[0::2, 2] = 1.0
        u = torch.rand(n, generator=env_c.generator)
        adv_c, _, beeps = env_c.advance_fn(st_c, a_c, u)
        if peds:
            adv_g, _, _ = env_g.advance_fn(to_g(st_c), a_c.to(device),
                                           u.to(device))
            for f in ("pos", "vel"):
                d = float((getattr(adv_c.peds, f)
                           - getattr(adv_g.peds, f).cpu()).abs().max())
                worst["ped_" + f] = max(worst["ped_" + f], d)
            assert torch.equal(adv_c.peds.gait_state,
                               adv_g.peds.gait_state.cpu())
            worst["beeps"] += int(beeps.sum())
        _, obs_g = env_g._observe(to_g(adv_c))
        st_c, obs_c = env_c._observe(adv_c)      # the CPU step
    assert worst["actions"] <= 1e-3, worst
    if peds:
        pos_tol, vel_tol = cc.PED_TOL[scene]
        assert worst["ped_pos"] <= pos_tol and worst["ped_vel"] <= vel_tol, \
            worst
        if scene == "ervoscene":
            assert worst["beeps"] > 0

    # the next episode, carrying the last state over
    sample, prev = env_c.sample_scenario(), st_c
    st_c, obs_c = env_c.reset(sample, carry=prev, dataset=dataset)
    st_g, obs_g = env_g.reset(cc.to_device(sample, device), carry=to_g(prev),
                              dataset=dataset)
    for a, b in zip(world_state_to_numpy(st_c).peds,
                    world_state_to_numpy(st_g).peds):
        assert (a == b).all()
    assert torch.equal(st_c.robots.vw_last1, st_g.robots.vw_last1.cpu())
    check_obs(obs_c, obs_g)
    return worst


@pytest.mark.parametrize("name", list(SMALL_CONFIGS))
def test_small_config_card_equals_cpu(dev, name):
    cfg_dict, dataset = SMALL_CONFIGS[name]
    small_reference(cfg_dict, dev, dataset)


@pytest.mark.parametrize("name", list(cc.SMALL_BATCHES))
def test_small_batch_card_equals_cpu(dev, name):
    """A small config as a scene batch on the card vs the same batch on
    the CPU, from one set of layouts, one noise draw and one beep draw per
    step; each step observed from the CPU states on both devices, the act
    compared on them too.  Collision and arrival codes, the ped surfaces,
    sensor maps and lasers exact (the kernels are bit-equal to their
    twins), actions within 1e-3."""
    cfg_dict, scenes = cc.SMALL_BATCHES[name]
    cfg = EnvConfig.from_dict(cfg_dict)
    n = cfg.robot.total
    env_c, env_g = BatchedNavEnv(cfg, "cpu"), BatchedNavEnv(cfg, dev)
    ctl_c = MpcController(env_c.core, MppiConfig(horizon=cc.H, samples=cc.K))
    ctl_g = MpcController(env_g.core, MppiConfig(horizon=cc.H, samples=cc.K))
    to_g = lambda x: world_state_from_numpy(world_state_to_numpy(x), dev)
    samples = [env_c.core.sample_scenario() for _ in range(scenes)]
    st_c, obs_c = env_c.reset(samples)
    _, obs_g = env_g.reset([cc.to_device(x, dev) for x in samples])
    exact = ["sensor_maps", "lasers", "is_collisions", "is_arrives"] + (
        ["ped_maps", "ped_vector_states", "ped_min_dists"]
        if cfg.ped_sim.total > 0 else [])

    def check_obs(obs_c, obs_g):
        for f in exact:
            a = getattr(obs_c, f)
            assert a.shape[:2] == (scenes, n), (f, a.shape)
            assert torch.equal(a, getattr(obs_g, f).cpu()), f

    ms = ctl_c.init_scenes_state(scenes)
    for _ in range(3):
        check_obs(obs_c, obs_g)
        noise = torch.randn((scenes, n, cc.K, cc.H, 2),
                            generator=ctl_c.generator)
        a_c, ms_next, _ = ctl_c.act_scenes(st_c, ms, noise)
        a_g, _, _ = ctl_g.act_scenes(to_g(st_c),
                                     MpcState(ms.nominal.to(dev)),
                                     noise.to(dev))
        assert float((a_c - a_g.cpu()).abs().max()) <= 1e-3
        ms = ms_next
        u = torch.rand((scenes, n), generator=env_c.core.generator)
        adv_c, _, _ = env_c.core.advance_scenes(st_c, a_c, u)
        _, obs_g = env_g.core.observe_scenes(to_g(adv_c))
        st_c, obs_c = env_c.core.observe_scenes(adv_c)
    check_obs(obs_c, obs_g)


def policy_inputs(obs):
    """The policy's inputs from a batch's Observation ([S, N, ...])."""
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    return (flat(obs.sensor_maps)[:, None], flat(obs.vector_states),
            flat(obs.ped_maps), flat(obs.ped_vector_states))


def test_policy_forward_card_equals_cpu(dev, stage5):
    """The stage-5 policy's forward on the card against the same module
    on the CPU, on bank50's reset observations: finite, and each output
    within POLICY_TOL (the convolutions and matmuls sum in other
    orders)."""
    policy, cfg = stage5
    _, _, obs = bank50_reset(cfg, dev)
    inputs = policy_inputs(obs)
    cpu = copy.deepcopy(policy).cpu()
    with torch.no_grad():
        got = policy(*inputs)
        want = cpu(*(x.cpu() for x in inputs))
    for name, g, w in zip(("mean", "log_std", "value"), got, want):
        g = g.detach().cpu()
        assert bool(torch.isfinite(g).all()), name
        assert torch.allclose(g, w, rtol=cc.POLICY_TOL, atol=cc.POLICY_TOL), \
            (name, float((g - w).abs().max()))


# ---- the evaluator ----

def test_eval_bank50(dev, stage5):
    """``evaluate_batched`` of the stage-5 policy over bank50's 50
    episodes at full width (50 scenes of one robot, 10 obstacles and 5 SFM
    leg peds, 400x400 views, 960 beams): every env step launches K1-K4
    once and K5 never, the done labels are the evaluator's, the arrive
    rate at least ARRIVE_FLOOR.  Then, from bank50's reset, 3 control
    steps with the policy and the step under host syncs made errors, and
    K1-K4 bit-equal to their twins at the states they reach."""
    policy, cfg = stage5
    assert cfg.robot.total == 1
    with cc.StepLaunches(cc.CROWD) as counted:
        summary, dones = evaluate_batched(
            cfg, mean_action_fn(policy, cfg), cc.EVAL_EPISODES,
            bank=ScenarioBank.load(cc.BANK50))
    assert counted.steps > 0
    assert dones.shape == (cc.EVAL_EPISODES, cfg.robot.total)
    assert set(np.unique(dones).tolist()) <= {1, 2, 3, 5, 10}
    assert summary["arrive_rate"] >= cc.ARRIVE_FLOOR, summary

    benv, states, obs = bank50_reset(cfg, dev)
    policy_fn = mean_action_fn(policy, cfg)
    for _ in range(3):
        torch.cuda.set_sync_debug_mode("error")
        try:
            a = policy_fn(None, obs)
            a = torch.cat([a, a.new_zeros(a.shape[:-1] + (1,))], -1)
            states, obs, *_ = benv.step(states, a)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    cc.kernels_match_twins(benv, states)


def test_small_evaluator_card_equals_cpu(dev):
    """The small evaluator config on the card vs the CPU port, with the
    exact P-controller (multiplies and clips): ``make_env`` with its
    wrapper stack for one episode (one bank episode on both), then
    ``evaluate_batched`` of 3 episodes with ``record=True``.  Filtered
    observations, rewards, dones, ``dones_info``, ``all_down``, the
    summary (its wall time aside) and the recorder's poses must be
    equal."""
    def p_control(generator, obs):
        vec = obs.vector_states
        return torch.stack([torch.clamp(0.8 * vec[..., 0], 0.0, 0.6),
                            torch.clamp(2.0 * vec[..., 1], -0.9, 0.9)], -1)

    d = dict(cc.SMALL_EVAL, cfg_type="bag", init_pose_bag_episodes=1)
    env_c, env_g = make_env(d, device="cpu"), make_env(d, device=dev)
    obs_c, obs_g = env_c.reset(carry=False), env_g.reset(carry=False)
    for _ in range(cc.SMALL_EVAL["time_max"] + 1):
        for a, b in zip(obs_c, obs_g):
            assert np.array_equal(a, b)
        act = p_control(None, env_c.last_raw_obs).numpy()
        obs_c, r_c, d_c, i_c = env_c.step(act)
        obs_g, r_g, d_g, i_g = env_g.step(act)
        for name, a, b in (("reward", r_c, r_g), ("done", d_c, d_g),
                           *((k, i_c[k], i_g[k]) for k in i_c)):
            assert np.array_equal(a, b), name
        if bool(i_c["all_down"]):
            break
    cfg = EnvConfig.from_dict(cc.SMALL_EVAL)
    (s_c, di_c, rec_c), (s_g, di_g, rec_g) = [
        evaluate_batched(cfg, p_control, 3, record=True, device=d)
        for d in ("cpu", dev)]
    s_c.pop("wall_s"), s_g.pop("wall_s")
    assert np.array_equal(di_c, di_g) and s_c == s_g, (s_c, s_g)
    for ec, eg in zip(rec_c.episodes, rec_g.episodes):
        for k in ("robot_poses", "robot_vws"):
            assert np.array_equal(ec.arrays()[k], eg.arrays()[k]), k


# ---- the rest of the MPC engine ----

LQT_TOL_F32 = 1e-4          # float32, of each output's largest entry
SMALL_MPC_TOL = 1e-3        # small iLQR and CEM actions; costs rtol 1e-4
                            # (float32 transcendentals differ)


def lqt_problems(dtype, robots: int = 200, h: int = 12, n: int = 3,
                 m: int = 2, seed: int = 14):
    """Random LQT problems, one per bench200 robot, as tests/test_lqr.py
    draws them (numpy from a seed)."""
    from img_env_tpu_torch.mpc import lqr

    rng = np.random.default_rng(seed)

    def psd(k, *batch):
        a = rng.normal(size=batch + (k, k))
        return a @ np.swapaxes(a, -1, -2) + k * np.eye(k)

    arrays = (rng.normal(size=(robots, h, n, n)) * 0.4 + np.eye(n),
              rng.normal(size=(robots, h, n, m)),
              rng.normal(size=(robots, h, n)) * 0.1,
              psd(n, robots, h) * 0.1, rng.normal(size=(robots, h, n)) * 0.1,
              psd(m, robots, h), rng.normal(size=(robots, h, m)) * 0.1,
              psd(n, robots), rng.normal(size=(robots, n)))
    return lqr.LqtProblem(*(torch.as_tensor(a.astype(dtype))
                            for a in arrays))


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_lqt_card_equals_cpu(dev, dtype):
    """``lqt_backward_assoc`` against ``lqt_backward_seq`` on the card,
    and the card against the CPU port, on 200 robots' problems (H = 12,
    n = 3, m = 2): float64 within tests/test_lqr.py's 1e-8, float32 within
    LQT_TOL_F32 of each output's largest entry."""
    from img_env_tpu_torch.mpc import lqr

    p_c = lqt_problems(dtype)
    p_g = lqr.LqtProblem(*(x.to(dev) for x in p_c))
    for a, b, c in zip(lqr.lqt_backward_assoc(p_g), lqr.lqt_backward_seq(p_g),
                       lqr.lqt_backward_assoc(p_c)):
        a, b, c = a.cpu().double(), b.cpu().double(), c.double()
        if dtype == np.float64:
            assert torch.allclose(a, b, rtol=1e-8, atol=1e-8)
            assert torch.allclose(a, c, rtol=1e-8, atol=1e-8)
        else:
            tol = LQT_TOL_F32 * float(c.abs().max())
            assert float((a - b).abs().max()) <= tol
            assert float((a - c).abs().max()) <= tol


def test_small_ilqr_and_cem_card_equals_cpu(dev):
    """``MpcController(method='ilqr').act_fn`` on SMALL's config from one
    reset state, card vs CPU (iLQR draws nothing), and ``cem_plan`` for
    robot 0 on injected draws: actions within SMALL_MPC_TOL, costs within
    rtol 1e-4, and the iLQR act moves the robots."""
    from img_env_tpu_torch.mpc import mppi

    cfg = EnvConfig.from_dict(cc.SMALL)
    env_c, env_g = NavEnv(cfg, "cpu"), NavEnv(cfg, dev)
    mcfg = MppiConfig(horizon=cc.H, samples=cc.K)
    ctl_c = MpcController(env_c, mcfg, method="ilqr")
    ctl_g = MpcController(env_g, mcfg, method="ilqr")
    st_c, _ = env_c.reset()
    st_g = world_state_from_numpy(world_state_to_numpy(st_c), dev)
    ms = ctl_c.init_state()
    a_c, ms_c, c_c = ctl_c.act_fn(st_c, ms)
    a_g, ms_g, c_g = ctl_g.act_fn(st_g, MpcState(ms.nominal.to(dev)))
    assert float((a_c - a_g.cpu()).abs().max()) <= SMALL_MPC_TOL
    assert float(((c_c - c_g.cpu()) / c_c).abs().max()) <= 1e-4
    assert float(a_c[:, :2].abs().max()) >= 0.05
    gen = torch.Generator().manual_seed(14)
    noise = torch.randn((mcfg.cem_iters, cc.K, cc.H, 2), generator=gen)
    outs = []
    for env_x, ctl_x, st_x in ((env_c, ctl_c, st_c), (env_g, ctl_g, st_g)):
        wc = ctl_x.world_cost(map_tree(lambda x: x[None], st_x))
        wc = wc._replace(scene=wc.scene[:1])
        r = st_x.robots
        outs.append(mppi.cem_plan(
            noise.to(env_x.device), mppi.init_planner(mcfg, env_x.device),
            r.pose[0], r.vw_last0[0], r.vw_last1[0], r.goal[0], wc,
            env_x.statics.limiter_v, env_x.statics.limiter_w,
            torch.zeros((cc.H, 0, 2), device=env_x.device),
            torch.zeros(0, device=env_x.device), mcfg))
    assert float((outs[0][0] - outs[1][0].cpu()).abs().max()) <= SMALL_MPC_TOL
    assert abs(float(outs[0][2]) / float(outs[1][2]) - 1) <= 1e-4


# BARN's floors: the JAX protocol's 0.9944 arrive share less ~10 binomial
# sigma at 300 episodes
BARN_ARRIVE_FLOOR = 0.95
BARN_STATIC_COLL_CEIL = 0.02


def test_barn_worlds(dev, tmp_path):
    """BARN with the goal field: worlds 0-99 generated
    (``generate_worlds(n=100, seed0=0)``), then ``run_barn_suite_batched``
    with run_barn's profile (goal-field MPPI H=8 K=64 and its corridor
    weights), 3 episodes a world, max_steps 150, one chunk of 100: 300
    episodes, every env step launching K1-K3 once, the arrive share at
    least BARN_ARRIVE_FLOOR and static collisions at most
    BARN_STATIC_COLL_CEIL.  Then, from a fresh reset of the same worlds
    and 3 steps: the goal fields card = CPU bit for bit, K1-K3 bit-equal
    to their twins at BARN's shapes."""
    from img_env_tpu_torch.datasets import barn
    from img_env_tpu_torch.eval import barn as eval_barn
    from img_env_tpu_torch.mpc.cost import geodesic_field

    mc, w8 = eval_barn.corridor_profile()
    worlds = barn.generate_worlds(str(tmp_path), n=100, seed0=0)
    cfg = EnvConfig.from_dict(barn.world_cfg_dict(worlds[0]))
    with cc.StepLaunches(cc.SENSORS):
        rows = eval_barn.run_barn_suite_batched(
            worlds, cfg, mpc=mc, mpc_weights=w8, episodes_per_world=3,
            max_steps=150, chunk=100, device="cuda")
    episodes = sum(r["episodes"] for r in rows)
    assert episodes == 300
    rate = lambda k: sum(r[k] * r["episodes"] for r in rows) / episodes

    benv = BatchedNavEnv(cfg, dev)
    ctl = MpcController(benv.core, mc, weights=w8)
    maps_t = torch.as_tensor(eval_barn.load_padded_maps(worlds, cfg),
                             device=dev)
    states, _ = benv.reset(100, static_maps=maps_t)
    mss = ctl.init_scenes_state(100)
    for _ in range(3):
        actions, mss, _ = ctl.act_scenes(states, mss)
        states, *_ = benv.step(states, actions)
    wc = ctl.world_cost(states)
    goals = states.robots.goal.reshape(-1, 2)
    field = lambda d: geodesic_field(wc.edt[wc.scene].to(d),
                                     float(wc.resolution), goals.to(d),
                                     wc.robot_radius)
    assert torch.equal(field(dev).cpu().view(torch.int32),
                       field("cpu").view(torch.int32))
    cc.kernels_match_twins(benv, states)
    assert rate("arrive_rate") >= BARN_ARRIVE_FLOOR
    assert rate("static_coll_rate") <= BARN_STATIC_COLL_CEIL


# ---- the experiment matrix, the frontends, the entry points ----

def check_render(env, states, obs, cfg):
    """render_frame, render_tiles and compose_gui of a beeping scene of the
    card's state equal the same functions of that state moved to the
    CPU."""
    from img_env_tpu_torch.eval.live_view import compose_gui
    from img_env_tpu_torch.eval.render import render_frame, render_tiles

    statics = env.core.statics
    beeping = states.robots.beep.any(-1).nonzero().flatten()
    k = int(beeping[0]) if beeping.numel() else 0
    card = map_tree(lambda x: x[k], states)
    host = map_tree(lambda x: x.cpu(), card)
    maps = obs.sensor_maps[k]
    assert np.array_equal(render_frame(card, statics, beep_radius=cfg.beep_r),
                          render_frame(host, statics, beep_radius=cfg.beep_r))
    assert np.array_equal(render_tiles(maps), render_tiles(maps.cpu()))
    assert np.array_equal(compose_gui(card, statics, maps, cfg),
                          compose_gui(host, statics, maps.cpu(), cfg))


def test_matrix_cells(dev, tmp_path):
    """The papers' experiment matrix through ``run_cell`` over bank50's 50
    scenes: part B's ORCA cell (rvoscene, the stage-5 policy) for 5
    control steps, then part C's two cells (the ERVO policy on ervoscene,
    beep on and forced off) for 20: every env step launches K1-K4 once
    and K5 never; robots beep with beep on and never with it off; one
    recorded episode a scene, one pose a step; the renderers of the card's
    state equal the CPU's; the indicator table of the two cells is
    written without matplotlib."""
    from img_env_tpu_torch.config import read_config
    from img_env_tpu_torch.eval import experiment_matrix as em
    from img_env_tpu_torch.eval import plots

    bank = ScenarioBank.load(cc.BANK50)
    ervo = read_config(em.ERVO_CFG)
    with cc.StepLaunches(cc.CROWD) as counted:
        em.run_cell(em.crowd_variant(ervo, "rvoscene", 2), "ckpt", bank,
                    cc.EVAL_EPISODES, ckpt=em.STAGE5, max_steps=5)
    assert counted.steps == 5
    recs = {}
    for beep, off in (("on", False), ("off", True)):
        with cc.StepLaunches(cc.CROWD) as counted:
            _, dones, rec = em.run_cell(
                ervo, "ckpt", bank, cc.EVAL_EPISODES, ckpt=em.ERVO,
                max_steps=20, force_beep_off=off, record=True)
        assert dones.shape == (cc.EVAL_EPISODES, 1)
        assert (int(counted.beeps) > 0) == (beep == "on")
        assert len(rec.episodes) == cc.EVAL_EPISODES
        assert len(rec.episodes[0].robot_poses) == counted.steps
        recs[f"beep {beep}"] = rec
        if beep == "on":
            check_render(*counted.last, EnvConfig.from_dict(ervo))
    had_matplotlib = "matplotlib" in sys.modules
    rows = {name: plots.per_robot_indicators(r)["all"]
            for name, r in recs.items()}
    assert plots.compare_methods(recs, str(tmp_path), figures=False) == rows
    assert os.listdir(tmp_path) == ["comparison.csv"]
    assert had_matplotlib or "matplotlib" not in sys.modules


class CircleSim:
    """A numpy unicycle among circle obstacles with two tracked peds: the
    external simulator of the frontend test.  Scans (``n_beams`` over the
    full circle) are cast on the host against CIRCLES; LOW is a kerb below
    the scan plane that only the bumper feels.  A command moves the robot
    one control period; a robot disc of ROBOT_R that then overlaps a
    circle or the kerb counts a contact, and a teleport clears the count.
    ``clearance`` (the least gap to a scanned circle's edge) and
    ``on_kerb`` keep the last move's ground truth."""

    CIRCLES = np.asarray([[2.0, -0.7, 0.3], [2.6, 1.1, 0.25],
                          [3.6, 0.2, 0.35], [1.2, 1.6, 0.2],
                          [4.4, 2.2, 0.3], [0.8, -1.5, 0.4]])
    LOW = np.asarray([[0.0, -1.0, 0.15]])
    ROBOT_R = 0.17

    def __init__(self, n_beams: int, dt: float):
        from img_env_tpu_torch.env.hardware_env import ScanSample, TrackedPed

        self.scan_cls, self.ped_cls = ScanSample, TrackedPed
        self.n_beams, self.dt = n_beams, dt
        self.pose = np.zeros(3)
        self.t = 0
        self.contacts = 0
        self.clearance, self.on_kerb = math.inf, False

    def set_model_state(self, x, y, yaw):
        self.pose = np.asarray([x, y, yaw], np.float64)
        self.contacts = 0

    def get_model_state(self):
        return tuple(self.pose)

    def send_cmd(self, v, w):
        x, y, th = self.pose
        self.pose = np.asarray([x + v * math.cos(th) * self.dt,
                                y + v * math.sin(th) * self.dt,
                                th + w * self.dt])

        def gap(c):
            return np.hypot(*(c[:, :2] - self.pose[:2]).T) - c[:, 2]

        self.clearance = float(gap(self.CIRCLES).min())
        self.on_kerb = bool((gap(self.LOW) < self.ROBOT_R).any())
        if self.clearance < self.ROBOT_R or self.on_kerb:
            self.contacts += 1
        self.t += 1

    def get_contact(self):
        c = self.contacts > 0
        self.contacts = 0
        return c

    def get_scan(self):
        ang = -math.pi + 2 * math.pi * np.arange(self.n_beams) / self.n_beams
        wa = ang + self.pose[2]
        dirs = np.stack([np.cos(wa), np.sin(wa)], -1)          # [R, 2]
        rel = self.CIRCLES[:, :2] - self.pose[:2]              # [C, 2]
        b = dirs @ rel.T                                       # [R, C]
        c = (rel ** 2).sum(-1) - self.CIRCLES[:, 2] ** 2
        disc = b ** 2 - c
        hit = b - np.sqrt(np.maximum(disc, 0.0))
        hit = np.where((disc >= 0) & (hit > 0), hit, np.inf)
        return self.scan_cls(ranges=hit.min(-1), angle_min=-math.pi,
                             angle_increment=2 * math.pi / self.n_beams)

    def get_peds(self):
        s = 0.1 * self.t
        return [self.ped_cls((1.5 + s, 0.4), (0.4, 0.0)),
                self.ped_cls((3.0, 2.0 - s), (0.0, -0.4))]

    def feed(self, hw) -> None:
        """Hand the scan, the pose and the tracked peds to a real_env."""
        hw.feed_scan(self.get_scan())
        hw.feed_pose(*self.get_model_state())
        hw.feed_peds(self.get_peds())


# the scripted episodes: (name, the done code they must end with, legs of
# (waypoint, how far short of it to stop)).  'min laser' heads for 0.13 m
# from a scanned circle's edge, inside the laser threshold (robot_radius,
# 0.17 m); 'contact' runs onto the kerb, which the scan does not see;
# 'arrival' drives round the circles to within the frontend's goal radius
# (1 m for gazebo_env, 0.3 m for real_env).  The frontends emit 0, 1 and 5
# only, in both packages: codes 2 and 3 are the simulator's ped and robot
# contacts.
ARRIVAL_LEGS = (((1.5, 0.3), 0.0), ((3.1, 0.65), 0.0), ((3.4, 1.0), 0.0),
                ((4.0, 1.5), 0.0))
SCRIPTS = {
    "gazebo_env": (("min laser", 1, (((2.0, -0.7), 0.43),)),
                   ("contact", 1, (((0.0, -1.0), 0.25),)),
                   ("arrival", 5, ARRIVAL_LEGS)),
    "real_env": (("arrival", 5, ARRIVAL_LEGS),),
}
SCRIPT_MAX_STEPS = 80       # per scripted episode
FRONTEND_STEPS = 30         # stage-5 policy steps on each frontend


def drive_cmd(pose, target, stop: float, dt: float):
    """The scripted controller's (v, w): turn in place toward ``target`` until
    the heading is within 0.05 rad, then drive so that the step ends
    ``stop`` m short of it, within the stage-5 action box (v in [0, 0.6],
    w in [-0.9, 0.9])."""
    dx, dy = target[0] - pose[0], target[1] - pose[1]
    err = math.atan2(dy, dx) - pose[2]
    err = math.atan2(math.sin(err), math.cos(err))
    w = max(-0.9, min(0.9, err / dt))
    if abs(err) > 0.05:
        return 0.0, w
    return max(0.0, min(0.6, (math.hypot(dx, dy) - stop) / dt)), w


def frontend_pair(kind: str, raw: dict, dev):
    """The stage-5 config with ``env_type`` switched, its wrapper stack over
    a frontend on the card and one on the CPU, each fed by its own
    CircleSim: ((card env, card sim), (CPU env, CPU sim)).  The frontends'
    vector state is the goal in the base frame and the relative yaw
    (``state_goal``), 3 wide in both packages, so ``state_dim`` is 3."""
    from img_env_tpu_torch.env.external_env import ExternalSimTransport

    d = dict(raw, env_type=kind, state_dim=3,
             start_global_pose=[0.0, 0.0, 0.0],
             target_global_pose=[4.0, 1.5])
    pairs = []
    for device in (dev, "cpu"):
        sim = CircleSim(int(raw["range_total"]), float(raw["control_hz"]))
        if kind == "gazebo_env":
            env = make_env(d, device=device, transport=ExternalSimTransport(
                get_scan=sim.get_scan, get_model_state=sim.get_model_state,
                set_model_state=sim.set_model_state, send_cmd=sim.send_cmd,
                get_contact=sim.get_contact, get_peds=sim.get_peds))
            env.env.real_time = False
        else:
            box = {}

            def send(v, w, sim=sim, box=box):
                sim.send_cmd(v, w)
                sim.feed(box["hw"])

            env = make_env(d, device=device, send_cmd=send)
            box["hw"] = env.env
            env.env.set_goal(4.0, 1.5)
            sim.feed(env.env)
        pairs.append((env, sim))
    return pairs


def _same(a, b) -> bool:
    """Equal nested dicts / sequences / tensors / arrays (NaN = NaN)."""
    if a is None or b is None:
        return a is b
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        a, b = a.cpu().numpy(), b.cpu().numpy()
    a, b = np.asarray(a), np.asarray(b)
    return np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def step_pair(env_g, env_c, action: np.ndarray) -> int:
    """One step of the card's and the CPU's frontend on the same action:
    the step's outputs and then the observations (raw and filtered) must
    be equal.  Returns the step's done code."""
    out_g, out_c = env_g.step(action), env_c.step(action)
    assert _same(out_g[1:], out_c[1:])
    assert _same(out_g[0], out_c[0])
    assert _same(env_g.last_raw_obs, env_c.last_raw_obs)
    return int(out_g[3]["dones_info"][0])


def scripted_episodes(kind: str, pairs) -> None:
    """SCRIPTS on one frontend pair: each episode from the start pose (a
    reset; real_env's robot is put back there first), driven by
    ``drive_cmd`` on the card sim's pose with the card and the CPU held
    equal at every step, must end with its code and agree with the sim's
    ground truth: 'min laser' inside the laser threshold of a scanned
    circle and off the kerb, 'contact' on the kerb and clear of the
    threshold."""
    (env_g, sim_g), (env_c, _) = pairs
    for name, want, legs in SCRIPTS[kind]:
        if kind == "real_env":
            for env, sim in pairs:
                sim.set_model_state(0.0, 0.0, 0.0)
                sim.feed(env.env)
        assert _same(env_g.reset(), env_c.reset())
        leg, codes = 0, []
        while len(codes) < SCRIPT_MAX_STEPS:
            target, stop = legs[leg]
            if leg + 1 < len(legs) and math.hypot(
                    target[0] - sim_g.pose[0],
                    target[1] - sim_g.pose[1]) - stop < 1e-3:
                leg += 1
                continue
            v, w = drive_cmd(sim_g.pose, target, stop, sim_g.dt)
            codes.append(step_pair(env_g, env_c, np.float32([[v, w]])))
            if codes[-1]:
                break
        assert codes[-1] == want and not any(codes[:-1]), (name, codes)
        # the last move's truth (a reset's teleport leaves it)
        clear, kerb = sim_g.clearance, sim_g.on_kerb
        if name == "min laser":
            assert clear < sim_g.ROBOT_R and not kerb, (clear, kerb)
        if name == "contact":
            assert kerb and clear >= sim_g.ROBOT_R, (clear, kerb)


@pytest.mark.parametrize("kind", ["gazebo_env", "real_env"])
def test_frontend_card_equals_cpu(dev, stage5, kind):
    """``make_env`` with 'gazebo_env' over a CircleSim transport, or with
    'real_env' fed scans, poses and tracked peds, under the stage-5
    config's wrapper stack on the card: every observation (the raw one on
    the device, the log-polar sensor map included) equal to the same
    frontend's on the CPU fed the same commands.  First the stage-5 policy
    drives FRONTEND_STEPS steps, its actions within POLICY_TOL of the
    CPU's (its 5-wide vector state is the frontend's 3 and the last
    command's (v, w)), and the sensor map holds a hit; then
    ``scripted_episodes`` drive the robot into each done code the frontend
    computes."""
    policy, cfg = stage5
    with open(cc.POLICY_ENV, encoding="utf-8") as f:
        raw = json.load(f)
    fns = (mean_action_fn(policy, cfg),
           mean_action_fn(copy.deepcopy(policy).cpu(), cfg))

    def act(k, env, last):
        obs = env.last_raw_obs
        vec = torch.cat([obs.vector_states,
                         last.to(obs.vector_states.device)[None]], -1)
        return fns[k](None, obs._replace(vector_states=vec))

    pairs = frontend_pair(kind, raw, dev)
    (env_g, _), (env_c, _) = pairs
    assert env_g.device.type == "cuda" and env_g.env.device.type == "cuda"
    assert _same(env_g.reset(), env_c.reset())
    last = torch.zeros(2)
    for _ in range(FRONTEND_STEPS):
        a_g, a_c = act(0, env_g, last), act(1, env_c, last)
        assert torch.allclose(a_g.cpu(), a_c, rtol=cc.POLICY_TOL,
                              atol=cc.POLICY_TOL)
        last = a_g[0].cpu()
        step_pair(env_g, env_c, last.numpy()[None])
    sm = env_g.last_raw_obs.sensor_maps
    assert sm.is_cuda and bool((sm == 1.0).any())
    scripted_episodes(kind, pairs)


def test_entry_points_on_the_card(dev, tmp_path):
    """``eval.evaluate --batch --policy ckpt`` over 4 bank episodes and
    ``examples.run_mpc --render`` at a few steps on the card: the
    evaluator prints its metrics, and the PNG reads back through the
    port's map loader as a colour image that is not blank."""
    from img_env_tpu_torch.env.maps import decode_png
    from img_env_tpu_torch.eval import evaluate
    from img_env_tpu_torch.examples import run_mpc

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        evaluate.main(["--batch", "--policy", "ckpt", "--episodes", "4",
                       "--max-steps", "3", "--bank", cc.BANK50])
    assert "arrive_rate" in buf.getvalue()
    png = str(tmp_path / "mpc.png")
    with contextlib.redirect_stdout(io.StringIO()):
        run_mpc.main(["--steps", "3", "--render", png])
    img = decode_png(png)
    assert img.ndim == 3 and img.shape[2] == 3 and img.max() != img.min()
