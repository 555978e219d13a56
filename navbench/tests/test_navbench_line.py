"""The last line: its keys, the checks last, a breakdown only in a traced
run; no card means no result and no fall-back to the CPU."""

import json
import os
import subprocess
import sys

import pytest

import tiny
from navbench import run, yardstick


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    d = tmp_path_factory.mktemp("checkout")
    return str(d), tiny.make_checkout(str(d))


def test_plain_line_keys(checkout):
    d, bench = checkout
    res = run.run_cell(bench, "bench200.step", 11, 0.5, False, "cpu", d)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    json.dumps(res)


def test_traced_line_has_breakdown(checkout, monkeypatch):
    d, bench = checkout
    events = [("raster_robots_kernel", 10.0, 20.0), ("gemm", 30.0, 60.0),
              ("memset", 55.0, 70.0)]
    labels = [("env_step", 0.0, 80.0), ("act", 20.0, 35.0)]
    fake = yardstick.reduce_trace(events, labels, 0.0, 100.0, 2)
    monkeypatch.setattr(run, "profile_steps", lambda drive, steps, log: fake)
    res = run.run_cell(bench, "bench200.mppi", 12, 0.5, True, "cpu", d)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert res["device"]["busy_s"] == pytest.approx(50e-6)
    assert res["device"]["window_s"] == pytest.approx(100e-6)
    assert res["breakdown"]["device_ops"][0] == ["gemm", pytest.approx(30e-6)]
    gaps = dict(res["breakdown"]["idle_gaps"])
    assert gaps["env_step"] == pytest.approx(10e-6)
    assert gaps["act"] == pytest.approx(10e-6)
    assert gaps["other"] == pytest.approx(30e-6)
    m = res["metrics"]
    assert m["device_idle_share.control"]["value"] == pytest.approx(50.0)
    assert m["device_ops_per_step.control"]["value"] == 1.5
    assert 0 < m["sensor_roofline.control"]["value"]


def test_untraced_line_has_no_breakdown(checkout):
    d, bench = checkout
    res = run.run_cell(bench, "stage5.eval50", 13, 0.5, True, "cpu", d)
    assert "breakdown" not in res     # no device events on the CPU
    assert set(res["metrics"]) == {"env_step_ms.batch", "policy_ms.batch"}


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the run exits non-zero and prints nothing on
    standard output (this sandbox's torch has no CUDA)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "navbench.run", "--workload",
                        "bench200.step", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tiny.ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr


def test_alone_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and navbench/ the run
    fails and prints no result."""
    import shutil

    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(tiny.HERE, tmp_path / "navbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = subprocess.run([sys.executable, "-m", "navbench.run", "--workload",
                        "bench200.step", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "img_env_tpu_torch_extra", sys)
    assert "img_env_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in run.forbidden_modules()
