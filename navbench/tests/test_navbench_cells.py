"""The harness finds every cell's configuration, traffic, loop, actor,
correctness limits and metric readers by name, and a new cell,
configuration, traffic mix (with a new actor and a new pattern of host
reads) or per-layer metric needs only new files and new BENCHMARK.json
entries."""

import json
import os

import pytest

import tiny
from navbench import run

with open(os.path.join(tiny.ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
    BENCH = json.load(f)
NB = tiny.HERE


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w, cfg, e2e, per_layer = run.find_cell(BENCH, cell)
    assert os.path.exists(os.path.join(tiny.ROOT, cfg["file"]))
    tr = run.load_json(os.path.join(NB, "traffic", w["traffic"] + ".json"))
    assert hasattr(run.load_part(NB, "loops", tr["loop"]), "Loop")
    actor = run.load_part(NB, "actors", tr["actor"])
    assert hasattr(actor, "Actor") and hasattr(actor, "Check")
    assert os.path.exists(os.path.join(NB, "checks", cell + ".json"))
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per_layer
    for m in e2e + per_layer:
        assert callable(run.reader(m["name"]))


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    for c in BENCH["configs"]:
        assert c["file"].startswith("navbench/")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    assert {m["name"] for m in BENCH["end_to_end"]} >= {
        "step_ms", "step_ms_p95", "robot_steps_per_s", "setup_s"}


def test_unknown_cell_and_metric_fail():
    with pytest.raises(run.RunError):
        run.find_cell(BENCH, "no.such.cell")
    with pytest.raises(run.RunError):
        run.reader("no_such_metric.control")
    with pytest.raises(run.RunError):
        run.load_part(NB, "actors", "no_such_actor")


def test_new_cell_config_and_metric_are_files_only(tmp_path):
    """A cell on a new configuration and traffic mix with a new per-layer
    metric: files and BENCHMARK.json entries, no edit of the harness."""
    bench = tiny.make_checkout(str(tmp_path))
    nb = tmp_path / "navbench"
    raw = json.loads((nb / "configs" / "bench200.json").read_text())
    raw["env"]["robot"]["total"] = 2
    (nb / "configs" / "two.json").write_text(json.dumps(raw))
    tr = tiny.tiny_traffic("random_step")
    tr["reads"] = ["commands", "codes"]
    (nb / "traffic" / "random_read.json").write_text(json.dumps(tr))
    (nb / "checks" / "two.random.json").write_text(json.dumps(
        json.loads((nb / "checks" / "bench200.step.json").read_text())))
    (nb / "metrics" / "steps_read.py").write_text(
        "def read(ctx, suffix):\n    return float(ctx['steps'])\n")
    bench["configs"].append(dict(bench["configs"][0], name="two",
                                 file="navbench/configs/two.json"))
    bench["workloads"].append({"name": "two.random", "config": "two",
                               "traffic": "random_read", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "steps_read", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "step_ms",
                               "workloads": ["two.random"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "bench200.step" in m["workloads"]:
            m["workloads"].append("two.random")
    res = run.run_cell(bench, "two.random", 5, 0.5, True, "cpu",
                       str(tmp_path))
    assert res["correct"] is True
    assert res["metrics"]["steps_read"]["value"] == res["attempted"]
    res = run.run_cell(bench, "two.random", 5, 0.5, False, "cpu",
                       str(tmp_path))
    assert set(res["metrics"]) == {"step_ms_p95", "setup_s"}


HOLD_ACTOR = '''"""Holds every robot at a constant command from the traffic file;
the reference has nothing of the actor's to compare."""
import torch


class Actor:
    def __init__(self, loop):
        self.loop = loop
        self.cmd = torch.tensor(loop.traffic["hold"], device=loop.dev)

    def reset(self):
        pass

    def act(self, keep):
        lp = self.loop
        lead = ((lp.scenes,) if lp.batch else ()) + (lp.robots,)
        return self.cmd.expand(lead + (3,)).clone(), {}

    def redraw(self, idx):
        pass


class Check:
    def __init__(self, replay):
        pass

    def compare(self, rd, state, obs, rec):
        rd.put("hold_seen", 1.0)
'''


def test_new_actor_and_reads_are_files_only(tmp_path):
    """A traffic mix with an actor that no file had and no per-step host
    read (the window ends on a synchronisation): an actor file, a traffic
    file, a check file and BENCHMARK.json entries, no edit of the
    harness; the actor's own reference side is read."""
    bench = tiny.make_checkout(str(tmp_path))
    nb = tmp_path / "navbench"
    (nb / "actors" / "hold.py").write_text(HOLD_ACTOR)
    tr = tiny.tiny_traffic("random_step")
    tr.update(actor="hold", hold=[0.3, 0.1, 0.0], reads=[])
    (nb / "traffic" / "hold_async.json").write_text(json.dumps(tr))
    lim = json.loads((nb / "checks" / "bench200.step.json").read_text())
    lim["limits"]["hold_seen"] = 1.0
    (nb / "checks" / "bench200.hold.json").write_text(json.dumps(lim))
    bench["workloads"].append({"name": "bench200.hold", "config": "bench200",
                               "traffic": "hold_async", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "bench200.step" in m["workloads"]:
            m["workloads"].append("bench200.hold")
    log = []
    res = run.run_cell(bench, "bench200.hold", 6, 0.5, False, "cpu",
                       str(tmp_path), log=log)
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["hold_seen"]["value"] == 1.0
    assert res["checks"]["codes"]["value"] == 0.0
    assert set(res["metrics"]) == {"step_ms_p95", "setup_s"}
