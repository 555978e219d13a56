"""The torch port imports and runs with JAX, the JAX package, OpenCV, PIL
and yaml all absent — the installation of the machine with the GPU: one
MPC act and env step without pedestrians, one with the SFM crowd, and one
with the ERVO crowd planned with the 'orca' head; and a scene batch
(``parallel``) with sensor groups, fast mode or no lasers, planned by the
scene-batched act; and the serving path: ``make_env`` on a dict, one
``evaluate_batched`` episode and the committed stage-5 policy through
``load_policy_npz``; and the training path: one PPO update of a fresh
policy on a scene batch with SFM peds, its checkpoint saved and restored,
and ``train.run``'s warm start from the committed npz; and the mesh
(``parallel.mesh``, ``parallel.distributed``, ``parallel.tp``,
``parallel.dryrun``) with ``core.frames``, ``utils.statics_cache`` and
``utils.debug``."""

import json
import os
import subprocess
import sys
import textwrap

from tests.test_torch_env import orca_cfg_dict, ped_cfg_dict, small_cfg_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import json
    import sys
    BLOCKED = ("jax", "jaxlib", "img_env_tpu", "cv2", "PIL", "yaml")
    for name in BLOCKED:
        sys.modules[name] = None          # any import of them now fails

    import torch
    import img_env_tpu_torch
    from img_env_tpu_torch import EnvConfig, MpcController, MppiConfig, NavEnv

    leaked = [m for m in sys.modules if sys.modules[m] is not None
              and m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    cfg = EnvConfig.from_dict(json.loads(sys.argv[1]))
    env = NavEnv(cfg, "cpu")
    ctl = MpcController(env, MppiConfig(horizon=4, samples=16),
                        ped_prediction=sys.argv[2])
    state, obs = env.reset()
    actions, _, costs = ctl.act(state, ctl.init_state())
    state, obs, reward, done, info = env.step(state, actions)
    n = cfg.robot.total
    assert obs.sensor_maps.shape == (n, 48, 48)
    assert obs.ped_maps.shape == (n, 3, 48, 48)
    for x in (obs.lasers, obs.ped_vector_states, obs.ped_maps, costs,
              state.peds.pos):
        assert bool(torch.isfinite(x).all())
    if len(sys.argv) > 3:
        # a scene batch: parallel/, env/nav_env.py's flat passes,
        # ops/polar.py's and ops/raster.py's scene forms, the scene act
        from img_env_tpu_torch import BatchedNavEnv
        benv = BatchedNavEnv(cfg, "cpu")
        ctl = MpcController(benv.core, MppiConfig(horizon=4, samples=16),
                            ped_prediction=sys.argv[2])
        s = int(sys.argv[3])
        states, obs = benv.reset(s)
        actions, _, costs = ctl.act_scenes(states, ctl.init_scenes_state(s))
        states, obs, reward, done, info = benv.step(states, actions)
        assert obs.sensor_maps.shape == (s, n, 48, 48)
        assert reward.shape == (s, n)
        assert bool(torch.isfinite(costs).all())
        leaked = [m for m in sys.modules if sys.modules[m] is not None
                  and m.split(".")[0] in BLOCKED]
        assert not leaked, leaked
    print("port-ok")
""")


SERVE_SCRIPT = textwrap.dedent("""
    import json
    import sys
    BLOCKED = ("jax", "jaxlib", "img_env_tpu", "cv2", "PIL", "yaml",
               "flax", "orbax")
    for name in BLOCKED:
        sys.modules[name] = None          # any import of them now fails

    import torch
    from img_env_tpu_torch import EnvConfig
    from img_env_tpu_torch.env.gymapi import make_env
    from img_env_tpu_torch.eval import evaluate_batched
    from img_env_tpu_torch.models import load_policy_npz, mean_action_fn

    d = json.loads(sys.argv[1])
    env = make_env(d, device="cpu")
    obs = env.reset()
    obs, reward, done, info = env.step([[0.3, 0.1]] * env.robot_total)
    assert reward.shape == (env.robot_total,) and "dones_info" in info
    with open("img_env_tpu_torch/artifacts/stage5_policy_env.json") as f:
        raw = json.load(f)
    raw["view_map"] = d["view_map"]
    raw["range_total"] = d["range_total"]
    cfg = EnvConfig.from_dict(raw)
    policy = load_policy_npz("img_env_tpu_torch/artifacts/stage5_policy.npz",
                             cfg, "cpu")
    summary, dones = evaluate_batched(cfg, mean_action_fn(policy, cfg), 1,
                                      max_steps=2, device="cpu")
    assert dones.shape == (1, 1) and summary["episodes"] == 1
    leaked = [m for m in sys.modules if sys.modules[m] is not None
              and m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("port-ok")
""")


TRAIN_SCRIPT = textwrap.dedent("""
    import json
    import os
    import sys
    import tempfile
    BLOCKED = ("jax", "jaxlib", "img_env_tpu", "cv2", "PIL", "yaml",
               "flax", "orbax", "optax")
    for name in BLOCKED:
        sys.modules[name] = None          # any import of them now fails

    import torch
    from img_env_tpu_torch import BatchedNavEnv, EnvConfig
    from img_env_tpu_torch.models.policy import PolicyConfig, init_policy
    from img_env_tpu_torch.train import PpoConfig, make_train_step, run
    from img_env_tpu_torch.train import checkpoint

    cfg = EnvConfig.from_dict(json.loads(sys.argv[1]))
    env = BatchedNavEnv(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    model, params = init_policy(gen, PolicyConfig.from_env_config(cfg),
                                "cpu")
    init_fn, train_step = make_train_step(
        env, model, PpoConfig(unroll=2, epochs=1, minibatches=2))
    states, obs = env.reset(2)
    ts, states, obs, m = train_step(init_fn(params), states, obs, gen)
    assert int(ts.step) == 1 and bool(torch.isfinite(m["loss"]))
    path = os.path.join(tempfile.mkdtemp(), "ts.pt")
    checkpoint.save(path, ts)
    back = checkpoint.restore(path, like=ts, device="cpu")
    assert all(torch.equal(back.params[k], v) for k, v in ts.params.items())
    with open("img_env_tpu_torch/artifacts/stage5_policy_env.json") as f:
        s5 = EnvConfig.from_dict(json.load(f))
    _, p5 = init_policy(gen, PolicyConfig.from_env_config(s5), "cpu")
    run.restore_params("img_env_tpu_torch/artifacts/stage5_policy.npz", p5)
    leaked = [m for m in sys.modules if sys.modules[m] is not None
              and m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("port-ok")
""")

MPC_BARN_SCRIPT = textwrap.dedent("""
    import json
    import os
    import sys
    import tempfile
    BLOCKED = ("jax", "jaxlib", "img_env_tpu", "cv2", "PIL", "yaml")
    for name in BLOCKED:
        sys.modules[name] = None          # any import of them now fails

    import torch
    from img_env_tpu_torch import EnvConfig, MpcController, MppiConfig, NavEnv
    from img_env_tpu_torch.core.state import map_tree
    from img_env_tpu_torch.datasets import barn
    from img_env_tpu_torch.eval import barn as eval_barn
    from img_env_tpu_torch.mpc import (LqtProblem, cem_plan, init_planner,
                                       lqt_backward_assoc, lqt_backward_seq)

    cfg = EnvConfig.from_dict(json.loads(sys.argv[1]))
    env = NavEnv(cfg, "cpu")
    ctl = MpcController(env, MppiConfig(horizon=4, samples=16),
                        method="ilqr")
    state, obs = env.reset()
    actions, ms, costs = ctl.act(state, ctl.init_state())
    assert actions.shape == (cfg.robot.total, 3)
    assert bool(torch.isfinite(costs).all())
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    eye = lambda k: torch.eye(k, dtype=torch.float64)
    p = LqtProblem(F=eye(3).expand(4, 3, 3) + 0.1 * r(4, 3, 3),
                   L=r(4, 3, 2), c=r(4, 3), Q=eye(3).expand(4, 3, 3),
                   q=r(4, 3), R=eye(2).expand(4, 2, 2), r=r(4, 2),
                   QT=eye(3), qT=r(3))
    assert torch.allclose(lqt_backward_seq(p)[2], lqt_backward_assoc(p)[2])
    wc = ctl.world_cost(map_tree(lambda x: x[None], state))
    wc = wc._replace(scene=wc.scene[:1])
    cfg_c = MppiConfig(horizon=4, samples=16, elites=4, cem_iters=2)
    act, ps, c = cem_plan(torch.randn(2, 16, 4, 2, generator=g),
                          init_planner(cfg_c, "cpu"), state.robots.pose[0],
                          state.robots.vw_last0[0], state.robots.vw_last1[0],
                          state.robots.goal[0], wc, env.statics.limiter_v,
                          env.statics.limiter_w, torch.zeros((4, 0, 2)),
                          torch.zeros(0), cfg_c)
    assert act.shape == (2,) and bool(torch.isfinite(c))

    out = tempfile.mkdtemp()
    worlds = barn.generate_worlds(os.path.join(out, "w"), n=2)
    wcfg = EnvConfig.from_dict(barn.world_cfg_dict(worlds[0], n_beams=32))
    mc, w8 = eval_barn.corridor_profile()
    rows = eval_barn.run_barn_suite_batched(
        worlds, wcfg, mpc=mc._replace(samples=8), mpc_weights=w8,
        episodes_per_world=1, max_steps=2, device="cpu",
        output_csv=os.path.join(out, "b.csv"))
    assert [r["episodes"] for r in rows] == [1, 1]
    rows = eval_barn.run_barn_suite(
        worlds[:1], wcfg, eval_barn.straight_policy, episodes_per_world=1,
        max_steps=2, device="cpu")
    assert len(rows) == 1 and "arrive_rate" in rows[0]
    leaked = [m for m in sys.modules if sys.modules[m] is not None
              and m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("port-ok")
""")


MESH_SCRIPT = textwrap.dedent("""
    import json
    import os
    import sys
    import tempfile
    BLOCKED = ("jax", "jaxlib", "img_env_tpu", "cv2", "PIL", "yaml",
               "flax", "orbax", "optax")
    for name in BLOCKED:
        sys.modules[name] = None          # any import of them now fails

    import torch
    from img_env_tpu_torch import BatchedNavEnv, EnvConfig
    from img_env_tpu_torch.core import frames
    from img_env_tpu_torch.models.policy import (PolicyConfig, example_inputs,
                                                 init_policy)
    from img_env_tpu_torch.parallel import distributed, dryrun, mesh, tp
    from img_env_tpu_torch.train import PpoConfig, make_train_step
    from img_env_tpu_torch.utils import statics_cache
    from img_env_tpu_torch.utils.debug import nan_debug

    os.environ[statics_cache.ENV_VAR] = tempfile.mkdtemp()
    assert not distributed.initialize()
    m = mesh.make_mesh(device_type="cpu")
    cfg = EnvConfig.from_dict(json.loads(sys.argv[1]))
    env = BatchedNavEnv(cfg, "cpu", mesh=m)
    states, obs = env.reset(2)
    assert mesh.shard_scenes(m, torch.arange(2)).tolist() == [0, 1]
    seeds = distributed.process_local_batch(m, (2,), torch.arange(2))
    assert seeds.to_local().tolist() == [0, 1]
    gen = torch.Generator().manual_seed(0)
    model, params = init_policy(gen, PolicyConfig.from_env_config(cfg),
                                "cpu")
    init_fn, train_step = make_train_step(env, model, PpoConfig(unroll=2))
    with nan_debug():
        ts, states, obs, met = train_step(init_fn(params), states, obs, gen)
    assert int(ts.step) == 1 and bool(torch.isfinite(met["loss"]))
    plan = mesh.tp_param_shardings(params, m)
    assert mesh.tp_sharded_fraction(params, plan) == 0.0
    out = tp.tp_forward(model, params, plan, m.get_group("model"),
                        *example_inputs(model.cfg, 2, "cpu"))
    assert out[0].shape == (2, cfg.act_dim)
    pose = torch.tensor([[1.0, 2.0, 0.5]])
    pts = frames.apply_se2(pose, torch.tensor([[[0.5, 0.0]]]))
    assert torch.allclose(frames.world_to_base(pose, pts),
                          torch.tensor([[[0.5, 0.0]]]), atol=1e-6)
    assert len(os.listdir(os.environ[statics_cache.ENV_VAR])) >= 1
    dryrun.worker("cpu")
    leaked = [m for m in sys.modules if sys.modules[m] is not None
              and m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("port-ok")
""")


def _run(cfg_dict, head="cv", scenes=None, script=SCRIPT):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"      # one torch thread, as in this process
    extra = [] if scenes is None else [str(scenes)]
    proc = subprocess.run([sys.executable, "-c", script,
                           json.dumps(cfg_dict), head, *extra], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "port-ok" in proc.stdout


def test_port_runs_without_jax_cv2_pil_yaml():
    _run(small_cfg_dict())


def test_port_crowd_step_without_jax_cv2_pil_yaml():
    d = ped_cfg_dict()
    d["paint_mode"] = "block"
    _run(d, head="sfm")


def test_port_ervo_crowd_step_without_jax_cv2_pil_yaml():
    _run(orca_cfg_dict("ervoscene"), head="orca")


def test_port_scene_batch_without_jax_cv2_pil_yaml():
    """Two scenes, fast mode, two sensor placements, SFM peds."""
    d = ped_cfg_dict(n_rob=3)
    d.update(sensor_mode="fast", fast_sensor_scale=2)
    d["robot"]["sensor_cfgs"] = [[0.15, 0.0], [-0.1, 0.08], [0.15, 0.0]]
    _run(d, scenes=2)


def test_port_scene_batch_without_lasers_or_jax():
    d = small_cfg_dict()
    d["use_laser"] = False
    _run(d, head="cv", scenes=3)


def test_serving_path_without_jax_cv2_pil_yaml():
    """The facade on a dict, the trusted evaluator and the committed
    stage-5 policy (views cut to the small config's)."""
    d = ped_cfg_dict()
    d["wrapper"] = ["VelActionWrapper", "TimeLimitWrapper",
                    "SensorsPaperRewardWrapper", "InfoLogWrapper",
                    "MultiRobotCleanWrapper", "StateBatchWrapper",
                    "ObsLaserStateTmp", "NeverStopWrapper"]
    _run(d, script=SERVE_SCRIPT)


def test_training_update_without_jax_optax_cv2_pil_yaml():
    """One PPO update of a fresh policy on two scenes of the SFM config."""
    _run(ped_cfg_dict(), script=TRAIN_SCRIPT)


def test_mpc_engine_and_barn_without_jax_cv2_pil_yaml():
    """An iLQR act, the LQT passes and CEM on the small config, and two
    generated BARN worlds through both suites (the batched one planning
    with the goal-field MPPI)."""
    _run(small_cfg_dict(), script=MPC_BARN_SCRIPT)


def test_port_mesh_training_and_library_without_jax():
    """A mesh of one: the sharded env, one PPO update under the NaN trap,
    the tensor-parallel plan and forward, frames, the statics cache, and
    the dryrun's rank function."""
    _run(ped_cfg_dict(), script=MESH_SCRIPT)
