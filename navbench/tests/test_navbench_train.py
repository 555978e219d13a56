"""The ``stage5.train32`` cell (PPO training of the stage-5 curriculum,
the ``ppo`` loop) at a tiny size on the CPU: its files are well formed;
the program's updates equal the reference's replay with every number 0,
plain and traced, with the phase and MFU metrics read; the bf16 control
fails; a program that trains with another learning rate or reward scale,
or that leaves half the scenes' peds unstepped, makes ``correct`` false.
The ``cuda`` case runs the cell at full size on the card: under every
limit, the TF32 control fails ``moments`` and the bf16 control a
number."""

import json
import os

import pytest
import torch

import tiny
from navbench import check, control, run
from navbench.drive import tmap

CELL = "stage5.train32"
NB = tiny.HERE


def _load(*parts):
    with open(os.path.join(NB, *parts), encoding="utf-8") as f:
        return json.load(f)


def tiny_traffic() -> dict:
    """The cell's traffic at 2 scenes, an unroll of 4 and a pool of 6."""
    tr = tiny.tiny_traffic("ppo_train32")
    tr["ppo"] = dict(tr["ppo"], unroll=4)
    return tr


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A tiny checkout with the cell: its stage5_train configuration cut
    as the other cells' stage5 (3 m views at 0.05 m, 96 beams), its time
    limit at 5 steps so that scenes finish and are redrawn within the
    compared updates."""
    d = str(tmp_path_factory.mktemp("checkout"))
    bench = tiny.make_checkout(d)
    nb = os.path.join(d, "navbench")
    raw = tiny._load("configs", "stage5_train.json")
    raw["env"] = dict(tiny.tiny_env("stage5"), time_max=5)
    raw["policy"] = os.path.join(tiny.ROOT, raw["policy"])
    with open(os.path.join(nb, "configs", "stage5_train.json"), "w") as f:
        json.dump(raw, f)
    with open(os.path.join(nb, "traffic", "ppo_train32.json"), "w") as f:
        json.dump(tiny_traffic(), f)
    with open(os.path.join(nb, "checks", CELL + ".json"), "w") as f:
        json.dump(_load("checks", CELL + ".json"), f)
    full = tiny._load_bench()
    for key in ("workloads", "end_to_end", "per_layer"):
        bench[key] = full[key]
    return d, bench


def test_cell_files_are_well_formed():
    bench = tiny._load_bench()
    w, cfg, e2e, per_layer = run.find_cell(bench, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("stage5_train",
                                                       "ppo_train32", 1)
    assert len(w["why"]) <= 200 and cfg["reduced"] == []
    # the deployment runs the stage5 env and policy as they stand
    stage5 = _load("configs", "stage5.json")
    mine = _load(*cfg["file"].split("/")[1:])
    assert {k: mine[k] for k in ("env", "policy", "policy_sha256",
                                 "precision")} == \
        {k: stage5[k] for k in ("env", "policy", "policy_sha256",
                                "precision")}
    assert mine["reduced"] == []
    assert {m["name"] for m in e2e} == {"robot_steps_per_s", "setup_s"}
    names = {m["name"] for m in per_layer}
    assert names == {"rollout_ms.train", "autoreset_ms.train",
                     "update_ms.train", "update_mfu.train",
                     "device_idle_share.train", "device_ops_per_step.train"}
    for m in per_layer:
        assert m["workloads"] == [CELL]
        assert m["moves"] == "robot_steps_per_s"
        assert callable(run.reader(m["name"]))
    tr = _load("traffic", "ppo_train32.json")
    assert tr["loop"] == "ppo" and tr["scenes"] == 32
    assert tr["ppo"] == {"unroll": 16, "epochs": 2, "minibatches": 2,
                         "lr": 3e-5, "ent_coef": 0.0005,
                         "reward_scale": 0.02, "log_std": -2.0}
    spec = _load("checks", CELL + ".json")
    assert spec["control"] == "tf32"
    assert set(spec["numbers"]) == set(spec["limits"])
    assert {"commands", "logp", "values", "rewards", "resets", "advantages",
            "loss", "moments", "params"} <= set(spec["limits"])
    assert spec["limits"]["resets"] == 0 and spec["limits"]["codes"] == 0


def test_program_equals_reference(checkout):
    d, bench = checkout
    log = []
    res = run.run_cell(bench, CELL, 2 ** 31 + 23, 0.5, False, "cpu", d,
                       log=log)
    assert res["correct"] is True, res["checks"]
    assert all(c["value"] == 0.0 for c in res["checks"].values()), \
        res["checks"]
    assert set(res["metrics"]) == {"robot_steps_per_s", "setup_s"}
    assert any(line.startswith("# updates in the window") for line in log)


def test_traced_run_reads_the_phases(checkout):
    d, bench = checkout
    res = run.run_cell(bench, CELL, 41, 0.5, True, "cpu", d)
    assert res["correct"] is True, res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert {"rollout_ms.train", "autoreset_ms.train", "update_ms.train",
            "update_mfu.train"} <= set(m)
    assert m["rollout_ms.train"] > 0 and m["update_ms.train"] > 0
    assert 0 < m["update_mfu.train"] < 100


def test_bf16_control_fails(checkout):
    d, bench = checkout
    limits = check.load_limits(os.path.join(NB, "checks", CELL + ".json"))
    got = control.readings(bench, CELL, 21, ["bf16"], "cpu", d)
    assert all(v == 0.0 for v in got["float32"].values()), got["float32"]
    ok, _ = check.judge(got["bf16"], limits)
    assert not ok


def _faulty(kind: str):
    """The program with one fault planted in its trainer or batch env."""
    from img_env_tpu_torch.train import ppo

    sut = run.program()
    if kind in ("lr_doubled", "reward_scale_halved"):
        def make_train_step(env, model, cfg):
            wrong = (cfg._replace(lr=2 * cfg.lr) if kind == "lr_doubled"
                     else cfg._replace(reward_scale=cfg.reward_scale / 2))
            return ppo.make_train_step(env, model, wrong)
        sut.make_train_step = make_train_step
        return sut

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
            new, obs, r, done, info = super().step(states, actions, beep_u)
            return (new._replace(peds=half(states.peds, new.peds)), obs, r,
                    done, info)

    sut.BatchedNavEnv = BEnv
    return sut


@pytest.mark.parametrize("kind,number", [
    ("lr_doubled", "params"), ("reward_scale_halved", "loss"),
    ("half_peds_unstepped", "peds")])
def test_fault_makes_correct_false(checkout, kind, number):
    d, bench = checkout
    res = run.run_cell(bench, CELL, 31, 0.5, False, "cpu", d,
                       sut=_faulty(kind))
    assert res["correct"] is False, res["checks"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


@pytest.fixture(scope="module")
def bench():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.set_caches(tiny.ROOT)
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json"),
              encoding="utf-8") as f:
        return json.load(f)


@pytest.mark.cuda
def test_card_cell_against_controls(bench):
    spec = _load("checks", CELL + ".json")
    got = control.readings(bench, CELL, 2 ** 31 + 99, ["tf32", "bf16"],
                           "cuda")
    ok, rows = check.judge(got["float32"], spec["limits"])
    assert ok, rows
    assert got["tf32"]["moments"] > spec["limits"]["moments"], got["tf32"]
    ok, rows = check.judge(got["bf16"], spec["limits"])
    assert not ok, rows
