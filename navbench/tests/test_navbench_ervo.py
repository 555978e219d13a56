"""The ``ervo.orca50`` cell (the IROS-21 ERVO crowd: ORCA peds that answer
the ERVO policy's beeps, the ``beep_batch`` loop) at a tiny size on the
CPU: the program equals the reference's ORCA env with every number 0;
the bf16 control fails; a program that ignores the harness's beep draws,
or that leaves half the scenes' peds unstepped, makes ``correct`` false;
the reference's ORCA modules load neither the program nor JAX.  The
``cuda`` cases run ``ervo.orca50`` and ``stage5.mppi50`` at full size on
the card: under every limit, and the cell's control fails one."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import tiny
from navbench import check, control, run
from navbench.drive import tmap

CELL = "ervo.orca50"


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A tiny checkout with the ervo configuration cut as the others are
    (3 m views at 0.05 m, 96 beams; 2 scenes, a pool of 6)."""
    d = str(tmp_path_factory.mktemp("checkout"))
    bench = tiny.make_checkout(d)
    nb = os.path.join(d, "navbench")
    raw = tiny._load("configs", "ervo.json")
    raw["env"] = tiny.tiny_env("ervo")
    raw["policy"] = os.path.join(tiny.ROOT, raw["policy"])
    with open(os.path.join(nb, "configs", "ervo.json"), "w") as f:
        json.dump(raw, f)
    with open(os.path.join(nb, "traffic", "ervo_stream50.json"), "w") as f:
        json.dump(tiny.tiny_traffic("ervo_stream50"), f)
    shutil.copy(os.path.join(tiny.HERE, "checks", CELL + ".json"),
                os.path.join(nb, "checks"))
    return d, bench


def test_program_equals_reference(checkout):
    d, bench = checkout
    res = run.run_cell(bench, CELL, 2 ** 31 + 17, 0.5, False, "cpu", d)
    assert res["correct"] is True
    assert set(res["checks"]) >= {"peds", "actions", "beeps"}
    assert all(c["value"] == 0.0 for c in res["checks"].values()), \
        res["checks"]


def test_bf16_control_fails(checkout):
    d, bench = checkout
    limits = check.load_limits(f"{tiny.HERE}/checks/{CELL}.json")
    got = control.readings(bench, CELL, 21, ["bf16"], "cpu", d)
    assert all(v == 0.0 for v in got["float32"].values())
    ok, _ = check.judge(got["bf16"], limits)
    assert not ok


def _faulty(kind: str):
    """The program with one fault planted in its batch step."""
    sut = run.program()

    def half(old, new):
        """The second half of the scenes left as they were."""
        def f(o, n):
            if o.dim() == 0 or o.shape != n.shape:
                return n
            k = o.shape[0] // 2
            return torch.cat([n[:k], o[k:]])
        return tmap(f, old, new)

    class BEnv(sut.BatchedNavEnv):
        def step(self, states, actions, beep_u=None):
            if kind == "beep_u_ignored":
                beep_u = None
            new, obs, r, done, info = super().step(states, actions, beep_u)
            if kind == "half_peds_unstepped":
                new = new._replace(peds=half(states.peds, new.peds))
            return new, obs, r, done, info

    sut.BatchedNavEnv = BEnv
    return sut


@pytest.mark.parametrize("kind", ["beep_u_ignored", "half_peds_unstepped"])
def test_fault_makes_correct_false(checkout, kind):
    d, bench = checkout
    res = run.run_cell(bench, CELL, 31, 0.5, False, "cpu", d,
                       sut=_faulty(kind))
    assert res["correct"] is False, res["checks"]
    number = "beeps" if kind == "beep_u_ignored" else "peds"
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


def test_reference_orca_loads_neither_program_nor_jax():
    mods = ("navbench.reference.crowd.orca",
            "navbench.reference.crowd.obstacle_split",
            "navbench.reference.env.orca_env")
    code = ("import json, sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "print(json.dumps(sorted({m.split('.')[0] "
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
@pytest.mark.parametrize("cell", [CELL, "stage5.mppi50"])
def test_card_cell_against_control(bench, cell):
    with open(os.path.join(tiny.HERE, "checks", cell + ".json"),
              encoding="utf-8") as f:
        spec = json.load(f)
    got = control.readings(bench, cell, 2 ** 31 + 99, [spec["control"]],
                           "cuda")
    ok, rows = check.judge(got["float32"], spec["limits"])
    assert ok, rows
    ok, rows = check.judge(got[spec["control"]], spec["limits"])
    assert not ok, rows
