"""The ``bench200ervo.mppi`` cell (one scene of robots planned by MPPI with
the 'orca' prediction head among ERVO peds that answer their beeps: the
``beep_control`` loop and the ``mppi_beep`` actor) at a tiny size on the
CPU: the program equals the reference with every number 0; the bf16
control fails; a program that ignores the harness's beep draws, or that
plans with the 'cv' head in place of 'orca', makes ``correct`` false; the
traced run reports the prediction's metrics; the reference's 'orca' head
loads neither the program nor JAX.  The ``cuda`` case runs the cell at
full size on the card: under every limit, and the cell's control fails
one."""

import copy
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import tiny
from navbench import check, control, run

CELL = "bench200ervo.mppi"
TRAFFIC = "mppi_ervo_fleet"
BOX = [[2.5, 7.5, 2.5, 7.5]]


def tiny_env() -> dict:
    """bench200ervo cut to a CPU test: 6 robots among 12 ERVO peds in a
    5 m box of room_10.png, 2 rectangles (so that the reset splits
    segments), 3 m views at 0.05 m, 96 beams."""
    env = copy.deepcopy(tiny._load("configs", "bench200ervo.json")["env"])
    env["view_map"] = {"resolution": 0.05, "width": 3.0, "height": 3.0}
    env["range_total"] = 96
    env["global_map"] = {"map_file": "room_10.png", "resolution": 0.1}
    env["robot"] = dict(env["robot"], total=6, begin_poses=BOX,
                        target_poses=BOX)
    env["ped_sim"] = dict(env["ped_sim"], total=12, begin_poses=BOX,
                          target_poses=BOX)
    env["object"] = {"total": 2, "shape": ["rectangle"],
                     "size_range": [[-0.15, 0.15, -0.15, 0.15]],
                     "poses_type": ["range"], "poses": BOX}
    return env


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("checkout"))
    bench = tiny.make_checkout(d)
    nb = os.path.join(d, "navbench")
    raw = tiny._load("configs", "bench200ervo.json")
    raw["env"] = tiny_env()
    with open(os.path.join(nb, "configs", "bench200ervo.json"), "w") as f:
        json.dump(raw, f)
    with open(os.path.join(nb, "traffic", TRAFFIC + ".json"), "w") as f:
        json.dump(tiny.tiny_traffic(TRAFFIC), f)
    shutil.copy(os.path.join(tiny.HERE, "checks", CELL + ".json"),
                os.path.join(nb, "checks"))
    return d, bench


def test_program_equals_reference(checkout):
    d, bench = checkout
    res = run.run_cell(bench, CELL, 2 ** 31 + 23, 0.5, False, "cpu", d)
    assert res["correct"] is True
    assert set(res["checks"]) >= {"peds", "actions", "mpc_costs", "beeps"}
    assert all(c["value"] == 0.0 for c in res["checks"].values()), \
        res["checks"]


def test_traced_run_reads_the_head(checkout):
    """``--trace 1`` on the CPU: the span phase files the host ms in
    ``mpc.predict`` and H·M agent-steps a control step."""
    d, bench = checkout
    res = run.run_cell(bench, CELL, 41, 0.5, True, "cpu", d)
    assert res["correct"] is True
    m = res["metrics"]
    tr = tiny.tiny_traffic(TRAFFIC)["mppi"]
    agents = tr["horizon"] * tiny_env()["ped_sim"]["total"]
    assert m["predict_agents_per_step.control"]["value"] == agents
    assert m["predict_ms.control"]["value"] > 0
    assert m["predict_ms.control"]["value"] <= m["act_ms.control"]["value"]


def test_bf16_control_fails(checkout):
    d, bench = checkout
    limits = check.load_limits(f"{tiny.HERE}/checks/{CELL}.json")
    got = control.readings(bench, CELL, 21, ["bf16"], "cpu", d)
    assert all(v == 0.0 for v in got["float32"].values())
    ok, _ = check.judge(got["bf16"], limits)
    assert not ok


def _faulty(kind: str):
    """The program with one fault planted: its env step ignores the
    harness's beep draws, or its controller plans with the 'cv' head."""
    sut = run.program()

    class Env(sut.NavEnv):
        def step(self, state, actions, beep_u=None):
            return super().step(state, actions)

    class Ctl(sut.MpcController):
        def __init__(self, env, cfg=None, *args, **kw):
            kw["ped_prediction"] = "cv"
            super().__init__(env, cfg, *args, **kw)

    if kind == "beep_u_ignored":
        sut.NavEnv = Env
    else:
        sut.MpcController = Ctl
    return sut


@pytest.mark.parametrize("kind,number", [("beep_u_ignored", "beeps"),
                                         ("cv_in_place_of_orca", "actions")])
def test_fault_makes_correct_false(checkout, kind, number):
    d, bench = checkout
    res = run.run_cell(bench, CELL, 31, 0.5, False, "cpu", d,
                       sut=_faulty(kind))
    assert res["correct"] is False, res["checks"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


def test_reference_orca_head_loads_neither_program_nor_jax():
    code = ("import json, sys\n"
            "import navbench.reference.mpc.orca_head\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(json.loads(out))
    assert not loaded & {"jax", "jaxlib", "flax", "img_env_tpu",
                         "img_env_tpu_torch"}


@pytest.fixture(scope="module")
def bench():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.set_caches(tiny.ROOT)
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json"),
              encoding="utf-8") as f:
        return json.load(f)


@pytest.mark.cuda
def test_card_cell_against_control(bench):
    with open(os.path.join(tiny.HERE, "checks", CELL + ".json"),
              encoding="utf-8") as f:
        spec = json.load(f)
    got = control.readings(bench, CELL, 2 ** 31 + 99, [spec["control"]],
                           "cuda")
    ok, rows = check.judge(got["float32"], spec["limits"])
    assert ok, rows
    ok, rows = check.judge(got[spec["control"]], spec["limits"])
    assert not ok, rows
