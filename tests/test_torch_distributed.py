"""The sharded PPO update, the tensor-parallel forward, the dryrun entry
point and ``initialize`` of ``img_env_tpu_torch.parallel`` (the port's
counterparts of ``tests/test_parallel.py``'s train-step tests and
``tests/test_distributed_dryrun.py``).

The ranks are gloo processes on the CPU (``parallel.distributed.spawn``,
rank functions in ``tests/torch_ranks.py``); their process group times
out after 60 s and each test kills them after at most 150 s, so a failing
rank ends the test.

Tolerances.  A two-rank update sums each minibatch's gradient as two
partial sums, and its advantage statistics as two partial sums, where one
process sums once: the loss and the parameters move by rounding.  The
loss is held within rtol 1e-5 of the one-process update's, the parameters
(clip + sgd 0.05; they move by ~1e-2) within 1e-6, and the gradient of
one minibatch within the error model of ``train.ppo`` (``GRAD_REL`` of
each leaf's largest sum of per-sample term magnitudes, plus ``GRAD_ABS``)
of the one-process gradient.  On every rank the loss is the same bits and
the parameters the same bytes.  The tensor-parallel forward is held to the
replicated one at atol = rtol = 1e-5, as ``tests/test_parallel.py`` holds
the JAX package's.
"""

import os
import subprocess
import sys

import pytest

from img_env_tpu_torch.parallel import distributed
from img_env_tpu_torch.parallel.distributed import spawn
from img_env_tpu_torch.parallel.dryrun import tiny_cfg_dict
from tests.test_torch_ppo import StepPair, check_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = tiny_cfg_dict(robots=1, peds=1)
RANKS = dict(backend="gloo", timeout_s=150, pg_timeout_s=60,
             env={"OMP_NUM_THREADS": "1"})


def _ok(runs):
    for rank, r in enumerate(runs):
        assert r.rc == 0, (rank, r.out[-2000:], r.err[-4000:])
    return [r.result for r in runs]


@pytest.mark.parametrize("minibatches", [1, 4])
def test_two_rank_update_matches_one_process(minibatches):
    """2 ranks x 1 scene of tiny_cfg(robots=1, peds=1), unroll 2, 4
    samples: one minibatch holds two samples of each rank, so the update
    normalises its advantages by the global statistics (per-rank ones
    would differ); with four minibatches of one sample each lies on one
    rank, and the other takes an empty share."""
    res = _ok(spawn("tests.torch_ranks:sharded_update", 2,
                    [TINY, 2, 2, 0, 1, minibatches], **RANKS))
    assert res[0]["loss_hex"] == res[1]["loss_hex"]
    assert res[0]["digest"] == res[1]["digest"]
    for r in res:
        assert r["step"] == 1
        assert r["moved"] > 1e-3
        assert abs(r["loss"] - r["one_loss"]) <= 1e-5 * abs(r["one_loss"])
        assert r["param_diff"] <= 1e-6, r["param_diff"]
        assert r["grad_ratio"] <= 1.0, r["grad_ratio"]


def test_scene_by_model_mesh_update_runs():
    """A 2 x 2 [scene, model] mesh of 4 ranks (tests/test_parallel.py:
    64-91): one update runs, the step is 1, the parameters moved; every
    rank's loss and parameters are the same; the tensor-parallel update
    stays within the stated tolerance of the one-process one."""
    res = _ok(spawn("tests.torch_ranks:sharded_update", 4,
                    [TINY, 2, 2, 0, 2], **RANKS))
    assert len({r["loss_hex"] for r in res}) == 1
    assert len({r["digest"] for r in res}) == 1
    for r in res:
        assert r["step"] == 1 and r["moved"] > 1e-3
        assert abs(r["loss"] - r["one_loss"]) <= 1e-5 * abs(r["one_loss"])
        assert r["param_diff"] <= 1e-6, r["param_diff"]
        assert r["grad_ratio"] <= 1.0, r["grad_ratio"]


def test_tensor_parallel_forward_matches_replicated():
    res = _ok(spawn("tests.torch_ranks:tp_plan", 4, [TINY, 0], **RANKS))
    for r in res:
        assert r["forward_ratio"] <= 1.0, r["forward_ratio"]


def test_one_process_update_matches_jax():
    """The one-process update of tiny_cfg(robots=1, peds=1) against the
    JAX package's ``make_train_step`` on its injected draws, held as
    tests/test_torch_ppo_crowd.py holds the SFM crowd's (an ORCA ped here:
    the crowd's float32 rounding reaches the poses)."""
    check_step(StepPair(dict(TINY, time_max=40)),
               dict(act=5e-4, logp=1e-5, value=5e-4, reward=1e-2, pose=5e-4,
                    metrics=1e-3, params=2e-5))


def test_dryrun_entry_point():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "img_env_tpu_torch.parallel.dryrun",
         "--procs", "2", "--device", "cpu", "--timeout", "150"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=200)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
    assert "distributed dryrun ok: 2 processes" in out.stdout
    assert out.stdout.count("agrees on 2 processes") == 2


def test_initialize_is_single_process_without_env(monkeypatch):
    for k in ("IMG_ENV_NUM_PROCESSES", "WORLD_SIZE", "RANK",
              "COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
