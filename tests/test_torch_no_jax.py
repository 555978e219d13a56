"""The torch port imports and runs with JAX, the JAX package, OpenCV, PIL
and yaml all absent — the installation of the machine with the GPU: one
MPC act and env step without pedestrians, one with the SFM crowd, and one
with the ERVO crowd planned with the 'orca' head."""

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
    print("port-ok")
""")


def _run(cfg_dict, head="cv"):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT,
                           json.dumps(cfg_dict), head], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
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
