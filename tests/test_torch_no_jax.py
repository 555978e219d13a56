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
``utils.debug``; and the frontends, the evaluation outputs and the
drivers (``utils.transforms``, ``utils.lidar``, ``utils.sarl``, the
hardware and external-simulator frontends through ``make_env`` and a fake
rospy, rendering, the headless viewer, the indicator table, the ERVO
policy, and every ``eval`` driver and example) with matplotlib blocked
too, as on the card's machine."""

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


FRONTEND_SCRIPT = textwrap.dedent("""
    import builtins
    import json
    import math
    import os
    import sys
    import tempfile
    import types
    BLOCKED = ("jax", "jaxlib", "img_env_tpu", "cv2", "PIL", "yaml",
               "matplotlib", "flax", "orbax")
    for name in BLOCKED:
        sys.modules[name] = None          # any import of them now fails

    import numpy as np
    import torch
    from img_env_tpu_torch import EnvConfig, NavEnv, make_env
    from img_env_tpu_torch.config import read_config
    from img_env_tpu_torch.env import gymapi, ros_bridge
    from img_env_tpu_torch.env.external_env import ExternalSimTransport
    from img_env_tpu_torch.env.hardware_env import ScanSample, TrackedPed
    from img_env_tpu_torch.env.maps import decode_png
    from img_env_tpu_torch.eval import (compare_methods, ervo_beep_demo,
                                        evaluate, experiment_matrix, plots)
    from img_env_tpu_torch.eval.live_view import LiveViewer, compose_gui
    from img_env_tpu_torch.eval.render import (render_frame, render_tiles,
                                               save_png)
    from img_env_tpu_torch.examples import console, run_mpc, run_random
    from img_env_tpu_torch.models.policy import load_ckpt_policy
    from img_env_tpu_torch.utils import lidar, sarl, transforms

    out = tempfile.mkdtemp()
    m = transforms.matrix_from_t_q([1, 2, 0], transforms.quaternion_from_yaw(
        0.3))
    assert np.allclose(transforms.mul_matrix(m, transforms.inverse(m)),
                       np.eye(4))
    img = lidar.trans_lidar_log_map(torch.linspace(0.2, 7.0, 960))
    assert img.shape == (48, 48) and bool((img == 1.0).any())
    rows, valid = sarl.batched_sarl_states(torch.zeros(3, 5),
                                           torch.zeros(3, 71), 0.17)
    assert rows.shape == (3, 10, 14) and valid[:, 0].all()

    class Sim:
        def __init__(self):
            self.pose = np.zeros(3)
        def set_model_state(self, x, y, yaw):
            self.pose = np.asarray([x, y, yaw], np.float64)
        def get_model_state(self):
            return tuple(self.pose)
        def send_cmd(self, v, w):
            x, y, th = self.pose
            self.pose = np.asarray([x + v * math.cos(th) * 0.4,
                                    y + v * math.sin(th) * 0.4,
                                    th + w * 0.4])
        def get_scan(self):
            ang = np.linspace(-math.pi, math.pi, 90, endpoint=False)
            return ScanSample(np.full(90, 2.0) + 0.3 * np.cos(ang),
                              -math.pi, 2 * math.pi / 90)
        def get_peds(self):
            return [TrackedPed((1.0, 1.0), (0.1, 0.0))]

    wrappers = ["VelActionWrapper", "TimeLimitWrapper",
                "SensorsPaperRewardWrapper", "InfoLogWrapper",
                "StateBatchWrapper", "ObsLaserStateTmp", "NeverStopWrapper"]
    d = {"robot": {"total": 1}, "ped_sim": {"total": 0},
         "global_map": {"resolution": 0.1, "map_file": "room_10.png"},
         "view_map": {"resolution": 0.05, "width": 3, "height": 3},
         "env_type": "gazebo_env", "range_total": 90, "time_max": 3,
         "start_global_pose": [0.0, 0.0, 0.0],
         "target_global_pose": [0.0, 3.0], "wrapper": wrappers}
    sim = Sim()
    env = make_env(d, device="cpu", transport=ExternalSimTransport(
        get_scan=sim.get_scan, get_model_state=sim.get_model_state,
        set_model_state=sim.set_model_state, send_cmd=sim.send_cmd,
        get_peds=sim.get_peds), wrap=True)
    env.env.real_time = False
    env.reset()
    for _ in range(5):
        obs, reward, done, info = env.step([0.3, 0.1])
    assert env.metrics.stuck == 1
    real = make_env(dict(d, env_type="real_env", control_hz=0.0),
                    device="cpu")
    real.env.feed_scan(sim.get_scan())
    real.reset()
    real.step([0.1, 0.0])

    class Rospy:
        def __init__(self):
            self.subs = {}
        def Publisher(self, topic, cls, queue_size=1):
            return types.SimpleNamespace(publish=lambda msg: None)
        def Subscriber(self, topic, cls, cb, queue_size=1):
            self.subs[topic] = cb
        def ServiceProxy(self, name, cls):
            return lambda *a, **k: None

    rospy = Rospy()
    bridge = ros_bridge.RealRobotBridge(EnvConfig.from_dict(d), rospy=rospy,
                                        device="cpu")
    rospy.subs["robot0/scan"](types.SimpleNamespace(
        ranges=np.full(90, 2.5), angle_min=-math.pi,
        angle_increment=2 * math.pi / 90))
    assert bridge.env.observe()["sensor_maps"].shape == (1, 48, 48)

    cfg = EnvConfig.from_dict(json.loads(sys.argv[1]))
    nav = NavEnv(cfg, "cpu")
    state, o = nav.reset()
    frame = render_frame(state, nav.statics, beep_radius=0.5)
    save_png(os.path.join(out, "f.png"), frame)
    assert (decode_png(os.path.join(out, "f.png")) == frame).all()
    assert render_tiles(o.sensor_maps).ndim == 3
    assert compose_gui(state, nav.statics, o.sensor_maps, cfg).ndim == 3
    viewer = LiveViewer(nav.statics, cfg)
    assert viewer.backend == "none" and viewer.update(state, o.sensor_maps
                                                      ) is not None

    small = {"view_map": {"resolution": 0.05, "width": 3.0, "height": 3.0},
             "range_total": 32, "time_max": 3}
    paths = {}
    for name, src in (("base", experiment_matrix.BASELINE_CFG),
                      ("ervo", experiment_matrix.ERVO_CFG)):
        paths[name] = os.path.join(out, name + ".json")
        with open(paths[name], "w") as f:
            json.dump(dict(read_config(src), **small), f)
    fn, _ = load_ckpt_policy(EnvConfig.from_yaml(paths["ervo"]),
                             experiment_matrix.ERVO, "cpu")
    evaluate.main([paths["base"], "--batch", "--policy", "ckpt",
                   "--episodes", "2", "--record", os.path.join(out, "r.npz"),
                   "--device", "cpu"])
    evaluate.main([paths["base"], "--policy", "random", "--episodes", "1",
                   "--max-steps", "2", "--device", "cpu"])
    compare_methods.main([paths["base"], "--episodes", "1", "--max-steps",
                          "2", "--methods", "random,ckpt", "--out",
                          os.path.join(out, "cmp"), "--device", "cpu",
                          "--no-figures"])
    experiment_matrix.main(["--episodes", "2", "--parts", "A,C",
                            "--no-figures", "--out", os.path.join(out, "m"),
                            "--baseline-cfg", paths["base"], "--ervo-cfg",
                            paths["ervo"], "--device", "cpu"])
    rows = open(os.path.join(out, "m", "matrix.csv")).read().splitlines()
    assert len(rows) == 6, rows
    ervo_beep_demo.main(["--steps", "2", "--out", "", "--device", "cpu"])
    run_random.main([paths["base"], "--episodes", "1", "--max-steps", "2",
                     "--render", os.path.join(out, "rr.png"),
                     "--device", "cpu"])
    run_mpc.main(["--steps", "2", "--robots", "2", "--samples", "8",
                  "--horizon", "3", "--render", os.path.join(out, "m.png"),
                  "--gui", "--device", "cpu"])
    cmds = iter(["step", "peek peds", "render " + os.path.join(out, "c.png"),
                 "quit"])
    builtins.input = lambda prompt="": next(cmds)
    console.main([paths["base"], "--device", "cpu"])
    assert decode_png(os.path.join(out, "c.png")).ndim == 3
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


def test_frontends_outputs_and_drivers_without_jax_or_matplotlib():
    """Steps 1-16 of the last slice: the library modules, both frontends
    under the wrapper stack and a fake rospy, rendering and the headless
    viewer, the ERVO policy, and every driver at 1-2 episodes."""
    _run(ped_cfg_dict(), script=FRONTEND_SCRIPT)
