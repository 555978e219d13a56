"""The port's evaluation drivers and examples (``python -m
img_env_tpu_torch.eval.{evaluate,compare_methods,experiment_matrix,
ervo_beep_demo}`` and ``img_env_tpu_torch.examples.{run_random,run_mpc,
console}``) at 2 episodes and at most 5 steps on the CPU, the exported
ERVO policy, and the JSON configs the card reads.

The experiment matrix's part A cells, part B's ORCA cell (rvoscene, the
stage-5 policy) and part C's cells are held to the JAX driver's
(``examples/experiment_matrix.py``'s ``run_cell``) on the JAX bank's
layouts, injected as a ``ScenarioBank`` of samples, with the configs cut
to 3 m views at 0.05 m, 32 beams and ``time_max`` 4.  The checkpoint and
random cells equal JAX's row for row but the wall time; the policies
differ by float32 summation order (rtol 1e-5, tests/test_torch_policy.py),
the SFM crowd drifts from rest (F15) and float32 ORCA by up to 2e-3 m/s
(F16), so the ped clearance is held within 0.025 m as
tests/test_torch_eval.py holds it.  The ERVO config answers every beep
(``ped_ca_p`` 1.0): the beep responses are then no draw, and the rows
equal.  MPPI's noise is the port's own (F4), so the mpc cell is held on
its labels only.  ``tools/matrix_cell_check.py`` runs a cell the same way
at the protocol's length.
"""

import functools
import importlib.util
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.config import read_yaml
from img_env_tpu.env.nav_env import NavEnv as JaxNavEnv
from img_env_tpu.eval.recorder import ScenarioBank as JaxScenarioBank
from img_env_tpu_torch.config import EnvConfig, read_config
from img_env_tpu_torch.env.maps import decode_png
from img_env_tpu_torch.eval import (compare_methods, ervo_beep_demo,
                                    evaluate, experiment_matrix)
from img_env_tpu_torch.eval.recorder import EpisodeRecorder, ScenarioBank
from img_env_tpu_torch.examples import console, run_mpc, run_random
from tests.test_torch_multiscene import jax_samples

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "img_env_tpu", "configs")
ARTIFACTS = os.path.join(REPO, "img_env_tpu_torch", "artifacts")
STAGE5_ORBAX = os.path.join(REPO, "docs/artifacts/baseline_curriculum/"
                                  "stage5_ckpt")
ERVO_ORBAX = os.path.join(REPO, "docs/artifacts/ervo/ckpt")
EPISODES = 2
CLEARANCE_TOL = 0.025     # F15, as tests/test_torch_eval.py states it


def small(raw: dict, **over) -> dict:
    d = dict(raw)
    d.update(view_map={"resolution": 0.05, "width": 3.0, "height": 3.0},
             range_total=32, time_max=4)
    d.update(over)
    return d


def base_cfg():
    return small(read_config(experiment_matrix.BASELINE_CFG))


def ervo_cfg():
    return small(read_config(experiment_matrix.ERVO_CFG), ped_ca_p=1.0)


@pytest.fixture(scope="module")
def cfg_files(tmp_path_factory):
    out = tmp_path_factory.mktemp("cfgs")
    paths = {}
    for name, d in (("base", base_cfg()), ("ervo", ervo_cfg())):
        paths[name] = str(out / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(d, f)
    return paths


# ------------------------------------------------------------- configs


def test_json_configs_equal_their_yaml():
    """The card's JSON configs give the yaml's EnvConfig, and so does each
    of part B's variants (a crowd strategy, an action width)."""
    for name, yaml_name in (("stage5_policy_env.json",
                             "baseline_10obs_5ped.yaml"),
                            ("ervo_policy_env.json", "ervo_crowd.yaml")):
        raw = read_config(os.path.join(ARTIFACTS, name))
        yaml_raw = read_config(os.path.join(CONFIGS, yaml_name))
        assert raw == yaml_raw
        assert EnvConfig.from_dict(raw) == EnvConfig.from_yaml(
            os.path.join(CONFIGS, yaml_name))
        assert EnvConfig.from_yaml(os.path.join(ARTIFACTS, name)) \
            == EnvConfig.from_dict(raw)
    ervo = read_config(experiment_matrix.ERVO_CFG)
    ervo_yaml = read_yaml(os.path.join(CONFIGS, "ervo_crowd.yaml"))
    for crowd in experiment_matrix.CROWDS:
        for act_dim in (2, 3):
            got = EnvConfig.from_dict(experiment_matrix.crowd_variant(
                ervo, crowd, act_dim))
            want = EnvConfig.from_dict(experiment_matrix.crowd_variant(
                ervo_yaml, crowd, act_dim))
            assert got == want
            assert got.ped_sim.type == crowd and got.act_dim == act_dim


def test_ervo_npz_matches_the_orbax_forward():
    """``artifacts/ervo_policy.npz`` holds the ERVO checkpoint's leaves
    exactly, and its act_dim-3 mean action equals the JAX loader's on
    observations with and without peds (rtol 1e-5)."""
    from img_env_tpu.core.state import Observation as JaxObservation
    from img_env_tpu.models import policy as jpolicy
    from img_env_tpu_torch.core.state import Observation
    from img_env_tpu_torch.models import policy as tpolicy
    from tests.test_torch_policy import TOL, _checkpoint, observations

    raw, flat = _checkpoint("ervo")
    with np.load(os.path.join(ARTIFACTS, "ervo_policy.npz")) as z:
        assert sorted(z.files) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(z[k], flat[k], err_msg=k)
    cfg = EnvConfig.from_dict(raw)
    assert cfg.act_dim == 3
    fn, _ = tpolicy.load_ckpt_policy(
        cfg, os.path.join(ARTIFACTS, "ervo_policy.npz"), "cpu")
    sm, vs, pm, pv = observations(cfg, seed=4)
    fields = dict(vector_states=vs, sensor_maps=sm[:, 0], ped_maps=pm,
                  ped_vector_states=pv)
    none = dict(is_collisions=None, is_arrives=None, lasers=None,
                step_ds=None, ped_min_dists=None)
    got = fn(None, Observation(**{k: torch.as_tensor(v)
                                  for k, v in fields.items()}, **none))
    assert got.shape == (vs.shape[0], 3)
    with jax.enable_x64(False):
        pf, params = jpolicy.load_ckpt_policy(JaxEnvConfig.from_dict(raw),
                                              ERVO_ORBAX, vs.shape[0])
        want = pf(params, JaxObservation(
            **{k: jnp.asarray(v) for k, v in fields.items()}, **none))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------- the matrix against JAX


@functools.lru_cache(maxsize=None)
def _jax_matrix():
    spec = importlib.util.spec_from_file_location(
        "jax_experiment_matrix", os.path.join(REPO, "examples",
                                              "experiment_matrix.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_cfg(part, crowd):
    """The test config of a matrix cell: part A's baseline, part B's crowd
    variant at action width 2, part C's ERVO config."""
    if part == "A":
        return base_cfg()
    if part == "B":
        return experiment_matrix.crowd_variant(ervo_cfg(), crowd, 2)
    return ervo_cfg()


@functools.lru_cache(maxsize=None)
def _banks(part, crowd):
    """(the JAX bank of keys, the port's bank of the same layouts)."""
    d = cell_cfg(part, crowd)
    jbank = JaxScenarioBank.generate(5, EPISODES)
    with jax.enable_x64(False):
        core = JaxNavEnv(JaxEnvConfig.from_dict(d), jit=False)
    samples = jax_samples(types.SimpleNamespace(core=core),
                          jnp.asarray(jbank.keys))
    return jbank, ScenarioBank(samples=samples)


LABELS = ("episodes", "arrive_rate", "static_coll_rate", "ped_coll_rate",
          "other_coll_rate", "stuck_rate", "avg_arrive_steps")


@pytest.mark.parametrize("part,method,beep", [
    ("A", "ckpt", "n/a"), ("A", "mpc", "n/a"), ("A", "random", "n/a"),
    ("B", "ckpt_baseline", "n/a"), ("C", "ckpt", "on"), ("C", "ckpt", "off")])
def test_matrix_cells_match_the_jax_driver(part, method, beep):
    crowd = {"A": "pedscene", "B": "rvoscene", "C": "ervoscene"}[part]
    d = cell_cfg(part, crowd)
    jbank, tbank = _banks(part, crowd)
    npz, orbax = ((experiment_matrix.ERVO, ERVO_ORBAX) if part == "C"
                  else (experiment_matrix.STAGE5, STAGE5_ORBAX))
    method = "ckpt" if method.startswith("ckpt") else method
    got = experiment_matrix.run_cell(d, method, tbank, EPISODES, ckpt=npz,
                                     force_beep_off=beep == "off",
                                     device="cpu")
    with jax.enable_x64(False):
        want = _jax_matrix().run_cell(d, method, jbank, EPISODES,
                                      ckpt=orbax,
                                      force_beep_off=beep == "off")
    row_t = experiment_matrix.matrix_row(part, "cfg", "crowd", method, beep,
                                         got[0])
    row_j = experiment_matrix.matrix_row(part, "cfg", "crowd", method, beep,
                                         want[0])
    assert set(row_t) == set(experiment_matrix.COLS)
    for k in LABELS:
        assert row_t[k] == row_j[k], k
    if method != "mpc":
        np.testing.assert_array_equal(got[1], want[1])
        assert row_t["close_to_human_rate"] == row_j["close_to_human_rate"]
        assert row_t["ped_min_dist_mean"] == pytest.approx(
            row_j["ped_min_dist_mean"], rel=0, abs=CLEARANCE_TOL)


def test_matrix_driver_writes_every_part(cfg_files, tmp_path):
    """``main`` over parts A-C at 2 episodes: 14 rows in the JAX driver's
    ``matrix.csv`` layout, part A's table and recorders without figures,
    then the figures drawn from the saved recorders (``--draw``)."""
    out = str(tmp_path / "m")
    args = ["--episodes", str(EPISODES), "--out", out, "--device", "cpu",
            "--baseline-cfg", cfg_files["base"], "--ervo-cfg",
            cfg_files["ervo"], "--bank", str(tmp_path / "none.npz")]
    experiment_matrix.main(args + ["--no-figures"])
    lines = open(os.path.join(out, "matrix.csv")).read().splitlines()
    assert lines[0] == ",".join(_jax_matrix().COLS)
    rows = [ln.split(",") for ln in lines[1:]]
    assert len(rows) == 14
    assert [r[0] for r in rows] == ["A"] * 3 + ["B"] * 9 + ["C"] * 2
    assert [r[3] for r in rows[3:6]] == ["ckpt_baseline", "ckpt_ervo",
                                         "mpc"]
    assert [r[4] for r in rows[-2:]] == ["on", "off"]
    compare = os.path.join(out, "compare")
    assert sorted(os.listdir(compare)) == [
        "comparison.csv", "recorder_ckpt.npz", "recorder_mpc.npz",
        "recorder_random.npz"]
    rec = EpisodeRecorder.load(os.path.join(compare, "recorder_ckpt.npz"))
    assert len(rec.episodes) == EPISODES
    experiment_matrix.main(args + ["--draw"])
    assert "traj_ckpt.png" in os.listdir(compare)


# ------------------------------------------------------- the other drivers


@pytest.mark.parametrize("policy", ["ckpt", "random", "mpc"])
def test_evaluate_batch(cfg_files, tmp_path, capsys, policy):
    bank = str(tmp_path / "bank.npz")
    rec = str(tmp_path / "rec.npz")
    evaluate.main([cfg_files["base"], "--batch", "--policy", policy,
                   "--episodes", str(EPISODES), "--bank", bank,
                   "--record", rec, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arrive_rate" in out and os.path.exists(bank)
    assert len(EpisodeRecorder.load(rec).episodes) == EPISODES
    assert len(ScenarioBank.load(bank)) == EPISODES


def test_evaluate_sequential_with_record_and_plots(cfg_files, tmp_path,
                                                   capsys):
    rec, plots = str(tmp_path / "rec.npz"), str(tmp_path / "plots")
    evaluate.main([cfg_files["base"], "--policy", "ckpt", "--episodes",
                   str(EPISODES), "--max-steps", "3", "--record", rec,
                   "--plots", plots, "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"{EPISODES} episodes in" in out and "avg_extra_time" in out
    assert len(EpisodeRecorder.load(rec).episodes) == EPISODES
    assert {"trajectories.png", "outcomes.png"} <= set(os.listdir(plots))


def test_compare_methods_driver(cfg_files, tmp_path):
    out = str(tmp_path / "cmp")
    compare_methods.main([cfg_files["base"], "--episodes", str(EPISODES),
                          "--max-steps", "3", "--methods", "mpc,random,ckpt",
                          "--out", out, "--device", "cpu"])
    files = set(os.listdir(out))
    assert {"comparison.csv", "comparison.png", "traj_mpc.png",
            "traj_random.png", "traj_ckpt.png"} <= files
    lines = open(os.path.join(out, "comparison.csv")).read().splitlines()
    assert [ln.split(",")[0] for ln in lines[1:]] == ["mpc", "random",
                                                      "ckpt"]
    compare_methods.main([cfg_files["base"], "--episodes", "1",
                          "--max-steps", "2", "--methods", "random",
                          "--out", out + "2", "--device", "cpu",
                          "--no-figures"])
    assert os.listdir(out + "2") == ["comparison.csv"]


def test_ervo_beep_demo(tmp_path, capsys):
    out = str(tmp_path / "beep.png")
    ervo_beep_demo.main(["--steps", "4", "--out", out, "--device", "cpu"])
    text = capsys.readouterr().out
    assert "(4 beeps fired)" in text
    assert decode_png(out).shape[0] > 100
    env_cfg = ervo_beep_demo.demo_cfg()
    from img_env_tpu_torch.env.nav_env import NavEnv

    env = NavEnv(env_cfg, "cpu")
    silent, b0 = ervo_beep_demo.rollout(env, 0.0, 4)
    beeping, b1 = ervo_beep_demo.rollout(env, 1.0, 4)
    assert (b0, b1) == (0, 4)
    centre = np.float32([5.0, 5.0])
    assert (np.linalg.norm(beeping[-1] - centre, axis=-1).mean()
            > np.linalg.norm(silent[-1] - centre, axis=-1).mean())


def test_run_random_and_run_mpc_render(cfg_files, tmp_path, capsys):
    png = str(tmp_path / "r.png")
    run_random.main([cfg_files["base"], "--episodes", "1", "--max-steps",
                     "3", "--render", png, "--device", "cpu"])
    assert "robot-steps/s" in capsys.readouterr().out
    assert decode_png(png).shape[-1] == 3
    png = str(tmp_path / "m.png")
    run_mpc.main(["--steps", "4", "--robots", "2", "--samples", "16",
                  "--horizon", "4", "--render", png, "--watch", "2",
                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert "4 steps in" in out and "wrote" in out
    img = decode_png(png)
    assert img.shape[0] > 100 and img.shape[2] == 3


def test_console_commands(cfg_files, tmp_path, monkeypatch, capsys):
    png = str(tmp_path / "c.png")
    lines = iter(["help", "step 0.2 0.1", "peek robots", "peek peds",
                  "peek obs", f"render {png}", "metrics", "reset 3",
                  "bogus", "quit"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
    console.main([cfg_files["base"], "--device", "cpu"])
    out = capsys.readouterr().out
    assert "env up: 1 robots, 5 peds" in out and "dones_info=" in out
    assert "reset ok" in out and "unknown command 'bogus'" in out
    assert decode_png(png).ndim == 3


def test_matrix_bounds_tool(tmp_path, capsys, monkeypatch):
    """``tools/matrix_bounds.py`` holds a port matrix.csv to the JAX
    artifact: the reference against itself is inside every bound; a cell
    moved by 0.3 is reported outside its bound (0.2444 at 0.79)."""
    import sys

    from tools import matrix_bounds

    ref = os.path.join(REPO, "docs", "artifacts", "matrix", "matrix.csv")
    lines = open(ref).read().splitlines()
    moved = [ln.replace("B,ervo_crowd,pedscene,ckpt_baseline,n/a,50,0.9400",
                        "B,ervo_crowd,pedscene,ckpt_baseline,n/a,50,0.6400")
             for ln in lines]
    port = tmp_path / "port.csv"
    port.write_text("\n".join(moved) + "\n")
    monkeypatch.setattr(sys, "argv", ["matrix_bounds", ref])
    matrix_bounds.main()
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last == {"cells": 14, "outside": []}
    monkeypatch.setattr(sys, "argv", ["matrix_bounds", str(port)])
    matrix_bounds.main()
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[-1])["outside"] == [
        ["B", "pedscene", "ckpt_baseline", "n/a"]]
    cell = json.loads(out[3])
    assert cell["delta"] == -0.3 and cell["bound"] == 0.2444
