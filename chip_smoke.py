"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``img_env_tpu_torch`` through its user entry points at the bench
configurations: bench200 (bench.py:31-56: 200 robots, 200 obstacles, 16 m
room at 0.015 m, 400x400 views, 960-beam lasers, MPPI K=128 H=12), the
crowd line bench200ped (bench.py:362-389: the same 200 robots with no
obstacles and 200 SFM leg pedestrians) and bench200ervo (bench200ped with
the ERVO crowd: ORCA pedestrians that step away from beeping robots,
beep_r 1.0 and ped_ca_p 0.8 as in img_env_tpu/configs/ervo_crowd.yaml):

  1. versions and the card (nvidia-smi name, power limit);
  2. builds the five CUDA kernels from ``img_env_tpu_torch/csrc`` (one
     nvcc per source, in parallel);
  3. NavEnv(cfg) + MpcController for bench200, bench200ped and
     bench200ervo;
  4. holds each kernel bit-equal to its plain-torch twin at the production
     shapes and times both (device time, the host's enqueue hidden),
     beside the least time the card could take (its bound: bytes over
     3.35 TB/s or operations over 67 T/s): K1 raster at bench200 on the
     reset and crowded poses, every robot stacked on one pose, robots on
     the map edges and footprints at the span limit; K2 FOV fill (with its
     bitmap pre-pass) and K3 painter at bench200, K2 also with robots on
     the map edges, on the crowd resets' maps and on two scenes stacked,
     K3 also on the crowd resets' thresholds, on no hits and on hits at
     every beam's first step, and timed on subsets of its layout; K5
     gen-1 painter at bench200; K4 ped map at bench200ped (the reset with
     a seeded velocity per ped, forced ties and peds on the window edge,
     tiny and subnormal ranges, no ped in any window, 600 peds in each);
  5. the bench200 path: reset + control steps (act, then step);
  6. the crowd path: bench200ped reset + 3 warm-up and 20 timed control
     steps, the bench.py crowd checksum; every step launches K1-K4, and
     the last warm-up step runs with host syncs made errors
     (torch.cuda.set_sync_debug_mode);
  7. the ERVO path: bench200ervo reset + 3 warm-up and 12 timed control
     steps ('cv' head) with the even robots beeping; every step launches
     K1-K4 and never K5, the last warm-up step without host syncs; then
     the device operations and time of one ORCA crowd step;
  8. the 'orca' prediction head: bench200ervo reset + 3 control steps
     with MpcController(ped_prediction="orca");
  9. the block-painter path: bench200 with paint_mode='block', reset + 3
     steps through K5 (never K3), its sensor maps and lasers equal to the
     default env's from one state;
 10. the small configs on the card vs the same port on the CPU (the CPU
     port is held to the JAX package by tests/test_torch_*.py): the test
     config without and with SFM pedestrians, copies of the shipped
     test.yaml (rvoscene, range_circle poses) and ervo_crowd.yaml
     (ervoscene, beeps), and a dataset scene replaying a seeded synthetic
     trajectory; each ends with a reset that carries the last state over;
 11. the scene batch, fast mode and sensor groups: BatchedNavEnv at
     bench.py's multi-scene line (bench200 with 50 robots a scene, 4
     scenes) and at 16 scenes of 12 robots, NavEnv at fast bench200 and
     fast bench200ped (sensor_mode 'fast', 133² views at 0.045 m) and at
     bench200 with two sensor placements; the kernels at these shapes
     against their twins (K1 over 4 and 16 scenes in one launch, K2 with
     each sensor group's in-scene ids and on the fast grid, K3 on each
     group's and the fast grid's tables, K5 on the fast tables, K4 at 4
     scenes x 50 robots x 200 peds); 3 warm-up and 10 timed control
     steps of the scene-batched act and the batch step at 4x50 and
     16x12 (host syncs made errors through every step; K1 exactly once a
     step, K2 and K3 once a step), of the two fast paths, and reset + 3
     steps with the groups (K2 and K3 twice a step); device operations
     and busy ms per step under torch.profiler; then small scene batches
     card vs CPU: a 4-scene crowd, 3 scenes with sensor groups, 2 fast
     scenes and 2 without lasers;
 12. the evaluation path: the stage-5 curriculum policy
     (img_env_tpu_torch/artifacts/stage5_policy.npz, load_policy_npz) on
     the card against the same module on the CPU at a reset of the
     baseline_10obs_5ped config, timed; ``evaluate_batched`` of that
     policy over the 50 episodes of docs/artifacts/baseline_curriculum/
     bank50.npz at full width (50 scenes of one robot, 10 obstacles and 5
     SFM leg peds in room_10, 400x400 views, 960 beams; at most 101
     steps), its summary, ms per control step, the policy's share, device
     operations, busy ms and idle share per step, the crowd's share
     (50 SFM scene steps), K1-K4 once a step and K5 never, the arrive
     rate at least ARRIVE_FLOOR; K1-K4 against their twins at these
     shapes; then the small evaluator config card vs CPU: one facade
     episode (make_env, its wrapper stack) and a 3-episode evaluation
     equal, the recorder's poses too;
 13. the training path under torch's default TF32 flags: a small SFM
     train step card vs CPU, the full-width gradients, 3 updates of the
     stage-5 continuation at 32 scenes, and three 50-update runs from
     scratch on easy_train's config;
 14. the rest of the MPC engine and the BARN benchmark (TF32 off again):
     the LQT passes at 200 robots x H=12 (assoc vs seq on the card, card
     vs CPU, float64 and float32); the small config's iLQR act and a CEM
     solve on injected draws card vs CPU; the iLQR control step at
     bench200 (2 warm-up and 5 timed steps, act ms, device operations and
     busy ms per act, host syncs per act; K1-K3 once per env step; the
     mean goal distance falls); BARN over generated worlds 0-99 x 3
     episodes with run_barn's goal-field MPPI (ms per control step, device
     operations of the fields, the rest of the act and the env step, idle
     share, peak memory; the fields card = CPU bit for bit; K1-K3 against
     their twins at BARN's shapes and once per step; arrive share at least
     BARN_ARRIVE_FLOOR, static collisions at most BARN_STATIC_COLL_CEIL).
 15. the mesh: the stage-5 continuation over ``make_mesh()`` (a world of
     one rank, NCCL) bit-equal to the same without a mesh; the statics of
     bench200 and of the production-shape program of
     __graft_entry__._production_cfg (8 scenes x 8 robots, 400x400 views,
     960 beams, two sensor groups, SFM leg peds) cold and warm through
     IMG_ENV_TPU_STATICS_CACHE; that program sharded over two spawned
     ranks on the card (gloo, CUDA tensors) for a reset and 3 steps, each
     rank bit-equal to the unsharded batch on its scenes and launching K1
     once, K2 and K3 twice and K4 once a step; and one PPO update of the
     stage-5 continuation sharded over the two ranks (16 scenes each):
     the loss and the parameters equal on both, the summed gradient
     within the error model of the one-process gradient.
 16. the papers' experiment matrix, the frontends and the drivers: one
     ORCA cell's control step timed (part B's rvoscene cell of the
     stage-5 policy over bank50's 50 scenes); part C's two cells (the
     ERVO policy, img_env_tpu_torch/artifacts/ervo_policy.npz, on
     ervoscene over the 50 scenes, beep on and forced off) through
     ``eval.experiment_matrix.run_cell``, reduced to MATRIX_STEPS control
     steps: K1-K4 once a step and K5 never, robot beeps with beep on and
     none with it off, the indicator table of the recorders without
     matplotlib, render_frame / render_tiles / compose_gui of the card's
     state equal to the CPU's, ms per control step, device operations,
     busy ms and idle share; ``make_env`` with 'gazebo_env' over a numpy
     unicycle among circles (scans cast on the host) and with 'real_env'
     fed scans, poses and tracked peds, each under the stage-5 config's
     wrapper stack, on the card with every observation (the log-polar
     sensor map included) equal to the CPU's: the stage-5 policy for
     FRONTEND_STEPS steps, its actions within POLICY_TOL (it turns in
     place), then scripted episodes that end by the min laser, a contact
     and arrival (done codes 1, 1, 5; real_env: 5); and
     ``eval.evaluate --batch --policy ckpt`` and ``examples.run_mpc
     --render`` at a few steps, the PNG read back by the map loader.

Each path's launch counts are set to 0 just before it and read just after
(per control step: the reset's launches left out).  Any failed phase
raises.  Prints the kernels' JSON line, then as its last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

BENCH200 = {
    "env_name": "bench200",
    "control_hz": 0.4,
    "robot": {
        "total": 200,
        "shape": ["circle"],
        "size": [[0.0, 0.0, 0.17]],
        "begin_poses_type": ["range"],
        "begin_poses": [[0.5, 15.5, 0.5, 15.5]],
        "target_poses_type": ["range"],
        "target_poses": [[0.5, 15.5, 0.5, 15.5]],
    },
    "object": {
        "total": 200,
        "shape": ["circle"],
        "size_range": [[0.1, 0.2]],
        "poses_type": ["range"],
        "poses": [[0.5, 15.5, 0.5, 15.5]],
    },
    "ped_sim": {"total": 0, "type": ""},
    "global_map": {"map_file": "room_16_empty.png", "resolution": 0.1},
    "view_map": {"resolution": 0.015, "width": 6.0, "height": 6.0},
    "range_total": 960,
    "max_ped": 10,
    "state_dim": 3,
}

BENCH200PED = {
    "env_name": "bench200ped",
    "control_hz": 0.4,
    "robot": dict(total=200, shape=["circle"],
                  size=[[0.0, 0.0, 0.17]],
                  begin_poses_type=["range"],
                  begin_poses=[[0.5, 15.5, 0.5, 15.5]],
                  target_poses_type=["range"],
                  target_poses=[[0.5, 15.5, 0.5, 15.5]]),
    "object": dict(total=0),
    "ped_sim": dict(total=200, type="pedscene",
                    max_speed=[0.5], shape=["leg"],
                    size=[[0.0, 0.1, 0.1]],
                    begin_poses_type=["range"],
                    begin_poses=[[0.5, 15.5, 0.5, 15.5]],
                    target_poses_type=["range"],
                    target_poses=[[0.5, 15.5, 0.5, 15.5]],
                    go_back="yes"),
    "global_map": {"map_file": "room_16_empty.png",
                   "resolution": 0.1},
    "view_map": {"resolution": 0.015, "width": 6.0,
                 "height": 6.0},
    "range_total": 960, "max_ped": 10, "state_dim": 3,
    "sensor_mode": "parity",
}

BENCH200ERVO = dict(BENCH200PED, env_name="bench200ervo",
                    ped_sim=dict(BENCH200PED["ped_sim"], type="ervoscene"),
                    beep_r=1.0, ped_ca_p=0.8)

SMALL = {
    "robot": {"total": 4, "shape": ["circle"], "size": [[0.0, 0.0, 0.17]],
              "begin_poses_type": ["range"],
              "begin_poses": [[2.0, 9.0, 2.0, 9.0]],
              "target_poses_type": ["range"],
              "target_poses": [[2.0, 9.0, 2.0, 9.0]]},
    "object": {"total": 3, "shape": ["circle", "rectangle"],
               "size_range": [[0.2, 0.3], [-0.15, 0.15, -0.15, 0.15]],
               "poses_type": ["range"], "poses": [[2.5, 8.5, 2.5, 8.5]]},
    "ped_sim": {"total": 0, "type": ""},
    "global_map": {"resolution": 0.1, "map_file": "room_10.png"},
    "view_map": {"resolution": 0.05, "width": 3, "height": 3},
    "image_size": [48, 48], "range_total": 96, "control_hz": 0.4,
    "max_ped": 4,
}

SMALL_PED = dict(SMALL, robot=dict(SMALL["robot"], total=2),
                 object=dict(SMALL["object"], total=2),
                 ped_sim={"total": 2, "type": "pedscene", "max_speed": [0.5],
                          "shape": ["leg", "circle"],
                          "size": [[0, 0.1, 0.1], [0, 0, 0.17]],
                          "begin_poses_type": ["range"],
                          "begin_poses": [[2.0, 9.0, 2.0, 9.0]],
                          "target_poses_type": ["range"],
                          "target_poses": [[2.0, 9.0, 2.0, 9.0]],
                          "go_back": "yes"},
                 ped_image_size=[48, 48])

# the shipped crowd configs (img_env_tpu/configs/test.yaml and
# ervo_crowd.yaml) with the views shrunk as in SMALL
_LIMITS = dict(min_velocity=0, max_velocity=0.6, min_acceleration=-1.6,
               max_acceleration=5)
_W_LIMITS = dict(min_velocity=-0.9, max_velocity=0.9, min_acceleration=-0.6,
                 max_acceleration=2)
_SHAPES4 = dict(shape=["circle", "rectangle", "circle", "rectangle"],
                poses_type=["range"] * 4)
SMALL_RVO = {
    "env_name": "test", "control_hz": 0.4, "laser_max": 6.0,
    "ped_safety_space": 0.7, "circle_ranges": [1.8, 2.0],
    "continuous_actions": [[0, 0.6], [-0.9, 0.9]],
    "max_ped": 10, "ped_vec_dim": 7, "ped_image_r": 0.3,
    "view_angle_begin": -1.570795, "view_angle_end": 1.570795,
    "view_min_dist": 0.0, "view_max_dist": 10.0,
    "beep_r": 1.0, "ped_ca_p": 1.0, "relation_ped_robo": 1,
    "speed_limiter_v": _LIMITS, "speed_limiter_w": _W_LIMITS,
    "global_map": {"resolution": 0.1, "map_file": "room_10.png"},
    "view_map": {"resolution": 0.05, "width": 3, "height": 3},
    "image_size": [48, 48], "ped_image_size": [48, 48], "range_total": 96,
    "robot": {"total": 1, "shape": ["circle"], "size": [[0, 0, 0.17]],
              "begin_poses_type": ["range_circle"],
              "begin_poses": [[5.5, 5.5]],
              "target_poses_type": ["range_circle"],
              "target_poses": [[5.5, 5.5]]},
    "object": dict(_SHAPES4, total=4,
                   size_range=[[0.3, 0.3], [-0.15, 0.15, -0.15, 0.15],
                               [0.3, 0.3], [-0.15, 0.15, -0.15, 0.15]],
                   poses=[[2.5, 8.5, 2.5, 8.5]] * 4),
    "ped_sim": {"total": 4, "type": "rvoscene", "max_speed": [0.5] * 4,
                "shape": ["leg"] * 4, "size": [[0, 0.1, 0.1]] * 4,
                "begin_poses_type": ["range_circle"] * 4,
                "begin_poses": [[5.5, 5.5]] * 4,
                "target_poses_type": ["range_circle"] * 4,
                "target_poses": [[5.5, 5.5]] * 4, "go_back": "yes"},
    "target_min_dist": 1.0,
}
_BOX = [[1.5, 9.0, 1.5, 9.0]]
SMALL_ERVO = dict(
    SMALL_RVO, env_name="ervo_crowd", control_hz=0.25, laser_max=10.0,
    laser_norm=True, ped_safety_space=0.4, state_dim=5, ped_ca_p=0.8,
    continuous_actions=[[0, 0.6], [-0.9, 0.9], [-0.6, 0.6]],
    speed_limiter_v=dict(_LIMITS, has_velocity_limits=True,
                         has_acceleration_limits=True),
    speed_limiter_w=dict(_W_LIMITS, has_velocity_limits=True,
                         has_acceleration_limits=True),
    robot=dict(SMALL_RVO["robot"], begin_poses_type=["range"],
               begin_poses=_BOX, target_poses_type=["range"],
               target_poses=_BOX),
    object=dict(SMALL_RVO["object"],
                size_range=[[0.2, 0.3], [-0.15, 0.15, -0.15, 0.15],
                            [0.2, 0.3], [-0.15, 0.15, -0.15, 0.15]],
                poses=[[2.0, 9.0, 2.0, 9.0]]),
    ped_sim={"total": 8, "type": "ervoscene", "max_speed": [0.5],
             "shape": ["leg"], "size": [[0, 0.1, 0.1]],
             "begin_poses_type": ["range"], "begin_poses": _BOX,
             "target_poses_type": ["range"], "target_poses": _BOX,
             "go_back": "yes"},
    target_min_dist=2.0)
SMALL_DATASET = dict(SMALL_PED, ped_sim=dict(
    SMALL_PED["ped_sim"], total=4, type="dataset", shape=["circle"],
    size=[[0, 0, 0.17]], max_speed=[1.0]))
# small configs as scene batches, card vs CPU: (config, S)
SMALL_BATCHES = {
    "multi-scene crowd": (SMALL_PED, 4),
    "sensor groups": (dict(SMALL, robot=dict(
        SMALL["robot"], sensor_cfgs=[[0.15, 0.0], [-0.1, 0.08],
                                     [0.15, 0.0], [0.0, 0.0]])), 3),
    "fast": (dict(SMALL_PED, sensor_mode="fast", fast_sensor_scale=3), 2),
    "no laser": (dict(SMALL, use_laser=False), 2),
}

# scene batches, fast mode and sensor groups (bench.py's multi-scene line is bench200 with 50 robots
# a scene, 4 scenes; benchmarks/multiscene_profile.py:21 the 16 x 12 shape;
# bench.py's fast lines are bench200 and bench200ped in sensor_mode
# 'fast'; the sensor groups are tests/test_hetero_sensors.py:24's offsets,
# even robots on the first, odd on the second)
MULTI_4X50 = dict(BENCH200, env_name="multi4x50", num_scenes=4,
                  robot=dict(BENCH200["robot"], total=50))
MULTI_16X12 = dict(BENCH200, env_name="multi16x12", num_scenes=16,
                   robot=dict(BENCH200["robot"], total=12))
FAST200 = dict(BENCH200, env_name="bench200fast", sensor_mode="fast")
FAST200PED = dict(BENCH200PED, env_name="bench200pedfast",
                  sensor_mode="fast")
GROUPS200 = dict(BENCH200, env_name="bench200groups", robot=dict(
    BENCH200["robot"], sensor_cfgs=[[0.15, 0.0], [-0.1, 0.08]] * 100))

K = 128
H = 12
WARMUP = 3
ITERS = 20          # timed crowd steps
BENCH_ITERS = 10    # timed bench200 steps
ERVO_ITERS = 12     # timed ERVO steps
BLOCK_STEPS = 3     # block-painter steps
BATCH_ITERS = 10    # timed steps of the multi-scene and fast paths
GROUP_STEPS = 3     # sensor-group steps

# the evaluation path (phase 12): the stage-5 curriculum policy and the env
# config it was trained with (img_env_tpu/configs/baseline_10obs_5ped.yaml,
# exported by tools/export_policy_npz.py), over the 50-episode bank that the
# README's result used, every episode a scene of one robot
POLICY_NPZ = "img_env_tpu_torch/artifacts/stage5_policy.npz"
POLICY_ENV = "img_env_tpu_torch/artifacts/stage5_policy_env.json"
BANK50 = "docs/artifacts/baseline_curriculum/bank50.npz"
EVAL_EPISODES = 50
# README: 0.86 arrive over these 50 episodes; the port's episodes are its
# own (the bank's keys seed torch generators), and a binomial spread is
# ~0.05, so 0.6 fails only a broken observation pipeline or weight import
ARRIVE_FLOOR = 0.6
# the policy forward, card vs CPU (float32, TF32 off): the convolutions
# and matmuls sum in other orders
POLICY_TOL = 1e-4
# tests/test_eval_parity.py's config with 3 m views at 0.05 m and
# time_max 10 (tests/test_torch_eval.py), without peds: the card's own
# trajectories equal the CPU's (the SFM's exp and atan2 differ in ulps
# between the devices, PED_TOL)
SMALL_EVAL = {
    "env_name": "eval_parity", "control_hz": 0.4, "time_max": 10,
    "state_dim": 3, "act_dim": 2, "discrete_action": False,
    "continuous_actions": [[0, 0.6], [-0.9, 0.9], [-0.6, 0.6]],
    "max_ped": 2, "range_total": 32,
    "wrapper": ["VelActionWrapper", "TimeLimitWrapper",
                "SensorsPaperRewardWrapper", "InfoLogWrapper",
                "MultiRobotCleanWrapper", "StateBatchWrapper",
                "ObsLaserStateTmp"],
    "robot": {"total": 2, "shape": ["circle"], "size": [[0.0, 0.0, 0.17]],
              "begin_poses_type": ["range"],
              "begin_poses": [[1.5, 8.5, 1.5, 8.5]],
              "target_poses_type": ["range"],
              "target_poses": [[1.5, 8.5, 1.5, 8.5]]},
    "object": {"total": 2, "shape": ["circle"], "size_range": [[0.15, 0.25]],
               "poses_type": ["range"], "poses": [[2.0, 8.0, 2.0, 8.0]]},
    "ped_sim": {"total": 0, "type": ""},
    "global_map": {"map_file": "room_10.png", "resolution": 0.1},
    "view_map": {"resolution": 0.05, "width": 3.0, "height": 3.0},
    "target_min_dist": 2.0,
}

# the training path (phase 13): the stage-5 polish stage of
# examples/train_curriculum.sh:44-48 (baseline_10obs_5ped, lr 3e-5,
# reward-scale 0.02, ent-coef 0.0005, pi_log_std forced to -2.0) at the
# curriculum's 32 scenes (:15), unroll 16, 2 epochs x 2 minibatches,
# warm-started from the stage-5 policy, 3 updates through train/run.py
TRAIN_UPDATES = 3
TRAIN_ARGS = [POLICY_ENV, "--scenes", "32", "--unroll", "16", "--epochs",
              "2", "--minibatches", "2", "--lr", "3e-5", "--reward-scale",
              "0.02", "--ent-coef", "0.0005", "--force-sigma", "-2.0",
              "--restore", POLICY_NPZ, "--updates", str(TRAIN_UPDATES),
              "--seed", "0"]
# docs/artifacts/baseline_curriculum/stage5.csv: each update's reward_mean
# between 9.8 and 25.2 (1st-99th percentile over 3,000 updates); a broken
# reward, policy or gradient sends it negative (stage 1's fresh policy
# starts near -6)
REWARD_FLOOR = 5.0
# the learning demo of README.md:101-104 (img_env_tpu/configs/
# easy_train.yaml as a dict: the card's machine has no PyYAML)
EASY_TRAIN = {
    "env_name": "easy_train",
    "robot": {"total": 1, "begin_poses_type": ["range"],
              "begin_poses": [[2.0, 8.0, 2.0, 8.0]],
              "target_poses_type": ["range"],
              "target_poses": [[2.0, 8.0, 2.0, 8.0]]},
    "ped_sim": {"total": 0},
    "global_map": {"map_file": "room_10.png", "resolution": 0.1},
    "view_map": {"resolution": 0.1, "width": 3.0, "height": 3.0},
    "range_total": 24, "image_size": [48, 48], "time_max": 40,
}
EASY_ARGS = ["--scenes", "16", "--unroll", "16", "--lr", "3e-4",
             "--reward-scale", "0.02", "--sigma0", "-1.0", "--updates", "50",
             "--seed", "0"]
# one run's reward_mean swings by +-10 between updates and may climb to ~20
# and fall back within 50 updates (the JAX package's runs dip too), so its
# first-10 vs last-10 comparison fails by chance; the check averages
# EASY_SEEDS runs
EASY_SEEDS = (0, 1, 2)
# the full-width gradient, card vs CPU: each leaf within the error model
# of img_env_tpu_torch.train.ppo (GRAD_REL of the leaf's largest sum of
# per-sample term magnitudes, plus GRAD_ABS); a leaf whose terms cancel
# (value.bias, pi_mean.bias) can sum to far below its terms, where a
# tolerance of 1e-4 of its own largest magnitude failed on rounding
# (tools/grad_terms.py); TF32 convolutions err by >= 3 times the tolerance
GRAD_SAMPLES = 256
# one small train step card vs CPU (clip + sgd 0.05): parameters within
# STEP_TOL (they move by ~5e-3)
STEP_TOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps back-to-back launches (after one
    warm-up).  A sleep kernel holds the stream while the host enqueues
    them, so a wrapper whose host work outlasts its kernel is timed by the
    kernel, not by the enqueue rate (the sleep lasts about twice the
    host-side time of the reps, at most 50 ms: enough for every wrapper
    here, while a slow twin is timed as before)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    lead_s = min(2.0 * reps * (time.perf_counter() - t0), 0.05)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(lead_s * 2e9))    # cycles, at most ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FLAT_OPS_PER_S = 67e12      # H100 SXM float32 rate outside the tensor cores,
                            # taken for the kernels' integer work as well


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by, nbytes, ops): the least time for ``nbytes``
    moved (each input read once, each output written once) and ``ops``
    operations."""
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = ops / FLAT_OPS_PER_S * 1e3
    return (b, "bytes", nbytes, ops) if b >= o else (o, "operations",
                                                     nbytes, ops)


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def fill_args(env, packed, poses, nps=None):
    """K2's arguments, with the pose terms as ``polar.fill_sorted`` makes
    them (glibc's sin/cos bits, ops/f32.py)."""
    from img_env_tpu_torch.ops import f32

    ps, t = env.statics.polar, env.tables.polar
    sin, cos = f32.sin_cos(poses[:, 2])
    return (packed, cos, sin,
            poses[:, 0].contiguous(), poses[:, 1].contiguous(), t.pix_x,
            t.pix_y, int(ps.n_fill_slots), env.statics.resolution, nps)


def check_fill(name, args):
    """K2 (the bitmap pre-pass and the fill) against its twin; returns the
    kernel's occupancy."""
    from img_env_tpu_torch.ops import polar

    occ_k = polar.fill_sorted_kernel(*args)
    occ_t = polar.fill_sorted_twin(*args)
    mism = int((occ_k != occ_t).sum())
    log(f"# K2 fill, {name}: {mism} mismatched slots of {occ_k.numel()} "
        f"({int(occ_k.sum())} occupied)")
    if mism:
        raise AssertionError(f"K2 fill kernel != twin ({name})")
    return occ_k


def thresholds(env, occ):
    from img_env_tpu_torch.ops import painter, polar

    _, _, aux = polar.raycast_batched(env.statics.polar, env.tables.polar,
                                      occ)
    return painter.hit_steps(env.statics.painter, env.tables.painter, *aux)


def block_tables(env):
    """K5's tables (the gen-1 64-slot blocks) for ``env``'s painter."""
    from img_env_tpu_torch.ops import painter

    pst = env.statics.painter
    return painter.make_painter_tables(
        pst, painter.PaintBlocks.build(pst, env.statics.view_params.range_total),
        env.device)


def check_paint(name, env, s_hit, s_tail, tb=None):
    """K3, and K5 over ``tb`` (K5's tables for ``env``) where given, each
    bit-equal to their twin on one set of thresholds; returns K3's output,
    the twin's and K5's."""
    from img_env_tpu_torch.ops import painter

    pst, t = env.statics.painter, env.tables.painter
    v_t = painter.paint_sorted(pst, t, s_hit, s_tail)
    outs = [painter.paint_slots_kernel(t, s_hit, s_tail, pst.n_slots)]
    if tb is not None:
        outs.append(painter.paint_blocks_kernel(tb, s_hit, s_tail,
                                                pst.n_slots))
    for kernel, v_k in zip(("K3 paint", "K5 block paint"), outs):
        mism = int((v_k != v_t).sum())
        log(f"# {kernel}, {name}: {mism} mismatched slots of {v_k.numel()}; "
            f"values {sorted(torch.unique(v_k).tolist())}")
        if mism:
            raise AssertionError(f"{kernel} kernel != twin ({name})")
    return outs[0], v_t, outs[-1]


def walk_tests(t, s_hit, s_tail, n_slots):
    """Visit tests the descending walk (K3's, and K5's over the same
    visits) needs for these thresholds: per robot and slot, its visits
    down to the first that writes (all of them when none writes).  Returns
    (tests, walked): ``walked`` counts the (robot, slot) pairs that the
    first two visits leave undecided, which a warp walks together."""
    off, visits = t.slots
    counts = (off[1:] - off[:-1]).long()
    slot = torch.repeat_interleave(
        torch.arange(n_slots, device=off.device), counts)
    pos = torch.arange(visits.numel(), device=off.device) - off[:-1].long()[slot]
    beam, T = (visits >> 16).long(), (visits & 0xFFFF).long()
    h, tail = s_hit.long()[:, beam], s_tail.long()[:, beam]
    writes = (T <= h) | (T == h + 1) | (T > tail)
    need = torch.where(writes, pos + 1, counts[slot])
    first = torch.full((s_hit.shape[0], n_slots), 1 << 30,
                       dtype=torch.int64, device=off.device).scatter_reduce(
        1, slot[None].expand_as(need), need, "amin")
    first = torch.where(counts == 0, 0, first)
    return int(first.sum()), int((first > 2).sum())


def minor_run_thresholds(s_hit, s_tail):
    """The thresholds with two of every three beams hit at step 0 and a
    minor run to the last step (s_tail = 2**14 - 1): their visits after the
    first step write nothing, so a slot's top visits often fall in minor
    runs and its warp walks down its list to the first writer."""
    sh, st = s_hit.clone(), s_tail.clone()
    sel = torch.arange(sh.shape[1], device=sh.device) % 3 != 0
    sh[:, sel], st[:, sel] = 0, 2 ** 14 - 1
    return sh, st


def k3_subsets(env, s_hit, s_tail):
    """K3 on subsets of its layout (each launch writes the whole output):
    only the dense near-sensor slots' visits (> 256 visiting beams), only
    the other visited slots' visits, and no visits at all (every slot 200:
    the store floor).  Returns {name: ms}."""
    import numpy as np

    from img_env_tpu_torch.ops import painter

    pst = env.statics.painter
    full = painter.PaintSlots.build(pst)
    counts = np.diff(full.off.astype(np.int64))
    out = {}
    for name, keep in (("dense", counts > 256),
                       ("rest", (counts > 0) & (counts <= 256)),
                       ("empty", np.zeros_like(counts, bool))):
        kc = np.where(keep, counts, 0)
        sub = painter.PaintSlots(
            off=np.concatenate([[0], np.cumsum(kc)]).astype(np.int32),
            visits=full.visits[np.repeat(keep, counts)])
        t = painter.make_painter_tables(pst, sub, s_hit.device)
        out[name] = cuda_ms(lambda: painter.paint_slots_kernel(
            t, s_hit, s_tail, pst.n_slots), 20)
        log(f"# K3 subset {name}: {int(keep.sum())} slots keep "
            f"{int(kc.sum())} visits, {out[name]:.4f} ms")
    return out


def crowded_poses(poses):
    """The poses with every odd robot pushed onto its even neighbour
    (forced overlaps: count 2, id sums)."""
    crowded = poses.clone()
    crowded[1::2, :2] = crowded[0::2, :2] + 0.1
    return crowded


def map_edge_poses(poses, h: int, w: int, res: float):
    """The poses with robots 0-43 on the map's four edges and corners."""
    edge = poses.clone()
    top_x, top_y = (h - 1) * res, (w - 1) * res
    edge[0:10, 0], edge[10:20, 0] = 0.0, top_x
    edge[20:30, 1], edge[30:40, 1] = 0.0, top_y
    edge[40:44, :2] = torch.tensor([[0.0, 0.0], [top_x, 0.0], [0.0, top_y],
                                    [top_x, top_y]], device=edge.device)
    return edge


def raster_cases(env, poses):
    """K1's inputs (name, cells [N, P, 2], valid [N, P]) at ``env``'s map:
    the reset poses; the crowded poses (timed); every robot stacked on
    robot 0's pose (count N, id sums up to N (N + 1) / 2); the crowded
    poses with robots straddling each map edge and corner; and circle
    footprints as wide as ``check_footprint_span`` admits (a span of
    RASTER_MAX_SPAN cells) at the crowded poses."""
    from img_env_tpu_torch.ops import footprint, raster

    t, res = env.tables, env.statics.resolution
    h, w = env.statics.static_map.shape
    to_cells = lambda p, pts: raster.world_to_cell(
        raster.transform_points(p, pts), res)
    crowded = crowded_poses(poses)
    big = footprint.circle_points(
        0.0, 0.0, (raster.RASTER_MAX_SPAN - 2.5) * res / 2)
    if raster.check_footprint_span(big[None], res) != raster.RASTER_MAX_SPAN:
        raise AssertionError("the span-limit footprint misses the limit")
    big = torch.as_tensor(big, device=poses.device).expand(
        poses.shape[0], -1, -1)
    cases = [("reset poses", poses), ("crowded poses", crowded),
             ("stacked on one pose", poses[:1].expand_as(poses)),
             ("on the map edges", map_edge_poses(crowded, h, w, res))]
    return ([(name, to_cells(p, t.robot_points), t.robot_mask)
             for name, p in cases]
            + [("footprints at the span limit", to_cells(crowded, big),
                torch.ones(big.shape[:2], dtype=torch.bool,
                           device=poses.device))])


def selfcheck(env, state, crowds):
    """Each kernel against its twin on the same device tensors at the
    production shapes, timed at bench200; ``crowds``: (name, env, state)
    of the crowd paths, whose packed maps and thresholds K2 and K3 are
    held on too.  Returns {name: (max_abs_err, ms, plain_ms, bound_ms,
    bound_by, bytes, operations)}."""
    from img_env_tpu_torch.ops import painter, raster

    st, t = env.statics, env.tables
    res = st.resolution
    h, w = state.obs_map.shape
    out = {}

    # K1: every case of raster_cases; timed on the crowded poses
    poses = state.robots.pose
    k1_err = 0.0
    cases = raster_cases(env, poses)
    for name, cells, valid in cases:
        got = raster.robot_maps_kernel(cells, valid, h, w)
        want = raster.robot_maps_twin(cells, valid, h, w)
        mism = int((got != want).sum())
        k1_err = max(k1_err, float((got.long() - want.long()).abs().max()))
        log(f"# K1 raster, {name}: {mism} mismatched cells of "
            f"{got.numel()}, max count {int((got & 0xFFF).max())}, "
            f"{int((got != 0).sum())} cells covered")
        if mism:
            raise AssertionError(f"K1 raster kernel != twin ({name})")
    cells = cases[1][1]
    k1_ms = cuda_ms(lambda: raster.robot_maps_kernel(cells, t.robot_mask,
                                                     h, w), 50)
    k1_plain = cuda_ms(lambda: raster.robot_maps_twin(cells, t.robot_mask,
                                                      h, w), 10)
    n, npts = t.robot_mask.shape
    out["raster"] = (k1_err, k1_ms, k1_plain,
                     *bound(nbytes(cells, t.robot_mask) + h * w * 4,
                            4 * n * npts))

    # K2: the crowded poses' packed map (timed); robots on the map's edges
    # and corners; the crowd states' maps (ped legs); two scenes stacked,
    # robot i reading scene i // 100
    from img_env_tpu_torch.ops import polar

    crowded = crowded_poses(poses)
    packed = raster.build_layers(
        state.obs_map, res, crowded, t.robot_points, t.robot_mask,
        torch.zeros((0, 3), device=poses.device),
        *([torch.zeros((0, 1, 2), device=poses.device),
           torch.zeros((0, 1), dtype=torch.bool, device=poses.device)] * 3)
    ).packed
    args = fill_args(env, packed, crowded)
    occ_k = check_fill("crowded poses", args)
    edge = map_edge_poses(crowded, h, w, res)
    check_fill("robots on the map edge", fill_args(env, packed, edge))
    unwrapped = crowded.clone()       # yaw is not wrapped as robots turn
    unwrapped[:, 2] += 2 * torch.pi * torch.arange(-3, 3, device=poses.device
                                                  ).repeat(n // 6 + 1)[:n]
    check_fill("yaws unwrapped by up to 3 turns", fill_args(env, packed,
                                                            unwrapped))
    crowd_occ = {}
    for name, env_c, state_c in crowds:
        crowd_occ[name] = check_fill(name, fill_args(
            env_c, env_c._layers(state_c).packed, state_c.robots.pose))
    n_half = poses.shape[0] // 2
    stacked = torch.stack([packed, crowds[0][1]._layers(crowds[0][2]).packed])
    check_fill("two scenes stacked", fill_args(env, stacked, crowded,
                                               n_half))
    k2_ms = cuda_ms(lambda: polar.fill_sorted_kernel(*args), 20)
    # bytes: the map, the gated prefix's slot coordinates (the suffix is
    # written as 0 unread), the four pose terms and the bool output
    maps = packed[None]
    n_slots, nf = t.polar.pix_x.shape[0], int(st.polar.n_fill_slots)
    out["fill"] = (0.0, k2_ms,
                   cuda_ms(lambda: polar.fill_sorted_twin(*args), 5),
                   *bound(nbytes(maps, t.polar.pix_x[:nf], t.polar.pix_y[:nf])
                          + 4 * 4 * n + n * n_slots,
                          10 * n * nf + 2 * maps.numel()))

    # K3 and K5 (the gen-1 64-slot blocks; the same twin): thresholds from
    # the raycast of the crowded occupancy (timed), from the crowd states,
    # and forced: no beam hits, every beam hits at its first step, and top
    # visits in minor runs (the warps' walks)
    tb = block_tables(env)
    s_hit, s_tail = thresholds(env, occ_k)
    v_k, v_t, v_b = check_paint("bench200 crowded", env, s_hit, s_tail, tb)
    err = float((v_k - v_t).abs().max())
    for name, env_c, _ in crowds:
        check_paint(name, env_c, *thresholds(env_c, crowd_occ[name]),
                    block_tables(env_c))
    miss = torch.full_like(s_hit, 2 ** 14)
    check_paint("no beam hits", env, miss, miss, tb)
    zero = torch.zeros_like(s_hit)
    tail0 = t.painter.nxt[:, 0][None].expand_as(s_hit).to(torch.int16)
    check_paint("every beam hits at step 0", env, zero, tail0.contiguous(),
                tb)
    minor = minor_run_thresholds(s_hit, s_tail)
    check_paint("top visits in minor runs", env, *minor, tb)
    walked = walk_tests(t.painter, *minor, st.painter.n_slots)[1]
    log(f"# minor runs: {walked} (robot, slot) pairs walked by their warp")
    if walked == 0:
        raise AssertionError("the minor-run case walks no slot")
    subsets = k3_subsets(env, s_hit, s_tail)
    tests, walked = walk_tests(t.painter, s_hit, s_tail, st.painter.n_slots)
    log(f"# K3 and K5 walk: {tests / n:.1f} visit tests per robot "
        f"({t.painter.slots[1].numel()} visits), {walked} (robot, slot) "
        "pairs walked by their warp")
    out["paint"] = (err, cuda_ms(lambda: painter.paint_slots_kernel(
        t.painter, s_hit, s_tail, st.painter.n_slots), 20),
        cuda_ms(lambda: painter.paint_sorted(st.painter, t.painter, s_hit,
                                             s_tail), 3),
        *bound(nbytes(s_hit, s_tail, *t.painter.slots, v_k),
               4 * tests + v_k.numel()))
    out["paint_subsets"] = subsets
    # K5's operations: the same walk, one per table entry (compacted into
    # the walk's lists), one per output slot
    n_wide, _, _, cap = tb.block_sizes
    log(f"# K5 layout: {tb.blocks[0].shape[0]} blocks ({n_wide} wide, "
        f"{int((tb.blocks[2] == 0).sum())} constant-200), "
        f"{tb.blocks[4].shape[0]} window rows, at most {cap} visits a block")
    out["paint_block"] = (
        float((v_b - v_t).abs().max()),
        cuda_ms(lambda: painter.paint_blocks_kernel(
            tb, s_hit, s_tail, st.painter.n_slots), 20),
        cuda_ms(lambda: painter.paint_sorted(st.painter, tb, s_hit, s_tail),
                3),
        *bound(nbytes(s_hit, s_tail, *tb.blocks, v_b),
               4 * tests + tb.blocks[4].numel() + v_b.numel()))
    return out


def pedmap_cases(env, state):
    """K4's inputs (name, (px, py, vx, vy) [N, M] f32 base frame) at the
    crowd reset of ``env``, each ped with its own seeded velocity (the
    reset's are all 0), so the vx/vy channels name the winning ped:

    * the reset's peds (N = M = 200);
    * ties (timed): every odd ped stacked on its even neighbour, peds on
      the +-3 m window's +x and -y edges, on the robot (range 0) and a
      ten-way tie;
    * tiny ranges: the reset's peds with some at subnormal range^2
      (|x| = 1e-20), at +0 from -0 coordinates and at a range^2 that
      underflows to 0 (|x| = 1e-23);
    * out of every window: the reset's peds 100 m off in x;
    * 600 in the windows: 600 peds per robot drawn over [-3.2, 3.2]^2
      (most inside the window, many covering every pixel)."""
    from img_env_tpu_torch.env import observe

    pos = state.peds.pos
    gen = torch.Generator(device=pos.device)
    gen.manual_seed(0)
    vel = torch.rand(pos.shape, generator=gen, device=pos.device) * 2 - 1
    reset = observe.peds_in_base(state.robots.pose, pos, vel)
    stacked = pos.clone()
    stacked[1::2] = stacked[0::2]
    px, py, vx, vy = (x.clone() for x in observe.peds_in_base(
        state.robots.pose, stacked, vel))
    px[:, 100:120:2] = 3.0                 # on the window's +x edge
    py[:, 120:140:2] = -3.0                # on its -y edge
    px[:, 140:150] = 0.0                   # on the robot (range 0)
    py[:, 140:150] = 0.0
    px[:, 150:160], py[:, 150:160] = 1.0, 0.5   # a ten-way tie
    tiny = [x.clone() for x in reset]
    tiny[0][:, 0:10], tiny[1][:, 0:10] = 1e-20, 0.0
    tiny[0][:, 10:20], tiny[1][:, 10:20] = -0.0, -0.0
    tiny[0][:, 20:30], tiny[1][:, 20:30] = -1e-23, 1e-23
    far = (reset[0] + 100.0, *reset[1:])
    n = state.robots.pose.shape[0]
    u = torch.rand((4, n, 600), generator=gen, device=pos.device)
    dense = ((u[0] * 6.4 - 3.2), (u[1] * 6.4 - 3.2), u[2] * 2 - 1,
             u[3] * 2 - 1)
    return [("reset", reset), ("ties", (px, py, vx, vy)),
            ("tiny ranges", tuple(tiny)), ("out of every window", far),
            ("600 in the windows", dense)]


def pedmap_pairs(base, res: float, r_img: float, hs: int) -> int:
    """(ped, pixel) pairs K4 tests: the pixels of each in-window ped's
    index box, clipped to the map."""
    from img_env_tpu_torch.ops import pedmap

    px, py = base[0], base[1]
    half = pedmap.HALF
    in_win = (px <= half) & (px >= -half) & (py <= half) & (py >= -half)
    in_x, in_y = pedmap.pixel_cover_bounds_exact(-px + half, -py + half, res,
                                                 r_img, hs)
    return int((in_x.sum(-1) * in_y.sum(-1) * in_win).sum())


def selfcheck_pedmap(env, state):
    """K4 against its twin on every case of ``pedmap_cases``, timed on the
    ties; on the ties, the twin with ties given to the smaller index must
    differ from the twin, or the check could not see K4's winner rule.
    Returns (max_abs_err, ms, plain_ms, bound_ms, bound_by, bytes,
    operations)."""
    from img_env_tpu_torch.ops import pedmap

    cfg = env.cfg
    hs, r_img = int(cfg.ped_image_size[0]), float(cfg.ped_image_r)
    res = 6.0 / hs
    err = 0.0
    cases = pedmap_cases(env, state)
    for name, base in cases:
        got = pedmap.ped_map_kernel(*base, res, r_img, hs)
        want = pedmap.ped_map_twin(*base, res, r_img, hs)
        mism = int((got != want).sum())
        err = max(err, float((got - want).abs().max()))
        occ = want[:, 0] > 0
        n_vx = int(torch.unique(want[:, 1][occ]).numel())
        log(f"# K4 ped map, {name}: {mism} mismatched of {got.numel()}, "
            f"{int(occ.sum())} occupied pixels, {n_vx} distinct vx, "
            f"{pedmap_pairs(base, res, r_img, hs)} (ped, pixel) pairs")
        if mism:
            raise AssertionError(f"K4 ped-map kernel != twin ({name})")
    base = cases[1][1]
    want = pedmap.ped_map_twin(*base, res, r_img, hs)
    # ties to the smaller index: the twin over the peds in reverse order
    flipped = pedmap.ped_map_twin(*(x.flip(1) for x in base), res, r_img, hs)
    seen = int((flipped[:, 1:] != want[:, 1:]).sum())
    log(f"# K4 tie rule: {seen} vx/vy values change when ties go to the "
        "smaller index")
    if seen == 0:
        raise AssertionError("K4 check cannot see the tie rule")
    # operations: a window test per (robot, ped), ~8 per (ped, pixel) pair
    # of the in-window peds' clipped index boxes, ~4 per output pixel
    n, m = base[0].shape
    return (err, cuda_ms(lambda: pedmap.ped_map_kernel(*base, res, r_img,
                                                       hs), 50),
            cuda_ms(lambda: pedmap.ped_map_twin(*base, res, r_img, hs), 5),
            *bound(nbytes(*base) + n * 3 * hs * hs * 4,
                   12 * n * m + 8 * pedmap_pairs(base, res, r_img, hs)
                   + 4 * n * hs * hs))


class PathRun(NamedTuple):
    state0: object        # the reset state
    state: object         # after the last step
    ms_step: float
    launches: dict
    per_step: dict        # launches per control step, the reset's left out
    checksum: float
    obs: object
    beeps: float          # beeping robots summed over the steps


def run_path(env, ctl, warmup: int, iters: int, must_launch, never=(),
             crowd: bool = False, beep: bool = False) -> PathRun:
    """Reset + ``warmup`` + ``iters`` control steps (act, then step) with
    the launch counts set to 0 just before and read just after.  Every
    step must launch each kernel of ``must_launch`` and none of ``never``;
    the last warm-up step runs with host syncs made errors.  ``beep``: the
    even robots beep (the action's third column; MPPI leaves it 0)."""
    from img_env_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    state, obs = env.reset()
    at_reset = dict(kernels.LAUNCHES)
    state0 = state
    mpc_state = ctl.init_state()
    zero = lambda: torch.zeros((), dtype=torch.float64, device=env.device)
    checksum, cost_sum, beeps = zero(), zero(), zero()

    def control_step(state, mpc_state):
        before = dict(kernels.LAUNCHES)
        actions, mpc_state, costs = ctl.act(state, mpc_state)
        if beep:
            actions[0::2, 2] = 1.0
        state, obs, reward, done, info = env.step(state, actions)
        chk = obs.sensor_maps.sum() + obs.lasers.sum()
        if crowd:   # bench.py:410-412: every crowd observation surface
            chk = (chk + obs.ped_vector_states.sum() + obs.ped_maps.sum()
                   + obs.ped_min_dists.sum())
        else:
            chk = chk + obs.vector_states.sum()
        idle = [k for k in must_launch if kernels.LAUNCHES[k] == before[k]]
        bad = [k for k in never if kernels.LAUNCHES[k] != before[k]]
        if idle or bad:
            raise AssertionError(f"a control step launched no {idle} / "
                                 f"launched {bad}")
        return state, mpc_state, obs, chk, costs.sum(), info["beeps"].sum()

    def run(state, mpc_state):
        state, mpc_state, obs, chk, c, b = control_step(state, mpc_state)
        checksum.add_(chk)
        cost_sum.add_(c)
        beeps.add_(b)
        return state, mpc_state, obs

    for i in range(warmup):
        # the last warm-up step runs with host syncs made errors: act and
        # step must stay capturable in a CUDA graph
        torch.cuda.set_sync_debug_mode("error" if i == warmup - 1 else 0)
        state, mpc_state, obs = run(state, mpc_state)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        state, mpc_state, obs = run(state, mpc_state)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / max(iters, 1) * 1e3
    launches = dict(kernels.LAUNCHES)
    per_step = {k: (v - at_reset[k]) / (warmup + iters)
                for k, v in launches.items()}
    if not (bool(torch.isfinite(checksum)) and bool(torch.isfinite(cost_sum))):
        raise AssertionError("non-finite checksum or MPC costs")
    return PathRun(state0, state, ms_step, launches, per_step,
                   float(checksum), obs, float(beeps))


def orca_step_cost(env, state):
    """Device operations, device busy ms and host ms of one ORCA crowd
    step (``NavEnv._orca_step``) from ``state``, the even robots beeping:
    operations and busy time from one call under torch.profiler, host ms
    over 5 synchronised calls."""
    from img_env_tpu_torch.crowd import common

    cfg = env.cfg
    r, p = state.robots, state.peds
    v_y = torch.zeros(r.pose.shape[0], device=env.device)
    v_y[0::2] = 1.0
    sources, radii, _ = common.sample_beeps(
        r.pose, v_y, float(cfg.beep_r), float(cfg.ped_ca_p),
        generator=env.generator)
    goals, _ = common.advance_traj_goals(p.pos, p.traj, p.traj_len,
                                         p.traj_idx)
    one = scene_axis(state)
    step = lambda: env._orca_step(one, goals[None], sources[None],
                                  radii[None])
    step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    return len(dev), busy, (time.perf_counter() - t0) / 5 * 1e3


def check_shapes(obs, expect):
    for f, shape in expect.items():
        x = getattr(obs, f)
        if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"bad {f} {tuple(x.shape)}")


def block_path(cfg_dict, env_default):
    """BENCH200 with paint_mode='block': reset + BLOCK_STEPS steps through
    K5 and never K3; then, from that state, the block env's sensor maps
    and lasers equal the default env's (K3) bit for bit."""
    from img_env_tpu_torch import EnvConfig, NavEnv
    from img_env_tpu_torch.ops import kernels

    env = NavEnv(EnvConfig.from_dict(dict(cfg_dict, paint_mode="block")),
                 env_default.device)
    kernels.reset_launch_counts()
    state, obs = env.reset()
    at_reset = dict(kernels.LAUNCHES)
    n = env.cfg.robot.total
    act = torch.zeros((n, 3), device=env.device)
    act[:, 0] = 0.4
    act[:, 1] = 0.3
    for _ in range(BLOCK_STEPS):
        before = dict(kernels.LAUNCHES)
        state, obs, *_ = env.step(state, act)
        if (kernels.LAUNCHES["paint_block"] == before["paint_block"]
                or kernels.LAUNCHES["paint"] != before["paint"]):
            raise AssertionError("block path: a step did not run K5 alone")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    per_step = {k: (v - at_reset[k]) / BLOCK_STEPS
                for k, v in launches.items()}
    _, o_b = env._observe(state)
    _, o_d = env_default._observe(state)
    for f in ("sensor_maps", "lasers", "is_collisions"):
        mism = int((getattr(o_b, f) != getattr(o_d, f)).sum())
        log(f"# block path: {f} {mism} mismatches vs the K3 env")
        if mism:
            raise AssertionError(f"block path: {f} differ from K3's")
    return launches, per_step


# crowd step, card vs CPU, from one state: (m, m/s) per crowd model
PED_TOL = {
    "pedscene": (1e-4, 5e-3),    # SFM: exp/atan2 ulps; the first step from
                                 # rest is ill-conditioned (ROADMAP F15)
    "rvoscene": (1e-3, 2e-3),    # ORCA: nearly parallel LP lines amplify
    "ervoscene": (1e-3, 2e-3),   # ulps (tests/test_torch_orca.py)
    "dataset": (0.0, 0.0),       # replay: a gather
}


def synthetic_dataset(m: int, t: int, dt: float, seed: int = 0):
    """Seeded replay arrays (traj [m,t,2], vel [m,t,2], length [m]) of
    random walks inside the 10 m room, each series of its own length."""
    g = torch.Generator().manual_seed(seed)
    steps = (torch.rand((m, t, 2), generator=g) - 0.5) * 0.4
    traj = 3.0 + 4.0 * torch.rand((m, 1, 2), generator=g) + steps.cumsum(1)
    length = torch.randint(t // 2, t + 1, (m,), generator=g, dtype=torch.int32)
    return traj, steps / dt, length


def small_reference(cfg_dict, device, dataset=None):
    """A small config on the card vs the same port on the CPU, from one
    layout, one noise draw and one beep draw per step.  Each step is
    observed from the CPU state on both devices (teacher forcing), so
    transcendental rounding cannot accumulate.  Sensor maps, lasers,
    collision and arrival codes must be equal.  With peds, the ped maps,
    ped vectors and min distances must be equal and the crowd step within
    PED_TOL; the ORCA crowds' split segments must be equal.  The ERVO
    config's even robots beep.  It ends with a reset on both devices that
    carries the last CPU state over, whose states and observations must be
    equal.  Returns the worst differences."""
    from img_env_tpu_torch import EnvConfig, MpcController, MppiConfig, NavEnv
    from img_env_tpu_torch.core.convert import (world_state_from_numpy,
                                                world_state_to_numpy)
    from img_env_tpu_torch.mpc.controller import MpcState

    cfg = EnvConfig.from_dict(cfg_dict)
    peds = cfg.ped_sim.total > 0
    scene = cfg.ped_sim.type if peds else ""
    n = cfg.robot.total
    env_c, env_g = NavEnv(cfg, "cpu"), NavEnv(cfg, device)
    ctl_c = MpcController(env_c, MppiConfig(horizon=H, samples=K))
    ctl_g = MpcController(env_g, MppiConfig(horizon=H, samples=K))
    to_g = lambda s: world_state_from_numpy(world_state_to_numpy(s), device)
    on_g = lambda sc: type(sc)(*(x.to(device) for x in sc))
    sample = env_c.sample_scenario()
    st_c, obs_c = env_c.reset(sample, dataset=dataset)
    st_g, obs_g = env_g.reset(on_g(sample), dataset=dataset)
    if not torch.equal(st_c.obs_map, st_g.obs_map.cpu()):
        raise AssertionError("small config: obstacle maps differ")
    segs_c, segs_g = st_c.obstacles.segs, st_g.obstacles.segs
    if scene in ("rvoscene", "ervoscene") and (segs_c is None
                                              or segs_g is None):
        raise AssertionError("small config: split segments missing")
    if segs_c is not None and not all(
            torch.equal(a, b.cpu()) for a, b in zip(segs_c, segs_g)):
        raise AssertionError("small config: split segments differ")
    worst = {"actions": 0.0}
    if peds:
        worst.update(ped_pos=0.0, ped_vel=0.0, beeps=0)
    exact = ["sensor_maps", "lasers", "is_collisions", "is_arrives"]
    if peds:
        exact += ["ped_maps", "ped_vector_states", "ped_min_dists"]

    def check_obs(obs_c, obs_g):
        for f in exact:
            if not torch.equal(getattr(obs_c, f), getattr(obs_g, f).cpu()):
                raise AssertionError(f"small config: {f} differ")

    ms = ctl_c.init_state()
    for step in range(4):
        check_obs(obs_c, obs_g)
        if step == 3:
            break
        noise = ctl_c.draw_noise()
        a_c, ms_next, _ = ctl_c.act(st_c, ms, noise)
        a_g, _, _ = ctl_g.act(to_g(st_c), MpcState(ms.nominal.to(device)),
                              noise.to(device))
        worst["actions"] = max(worst["actions"],
                               float((a_c - a_g.cpu()).abs().max()))
        ms = ms_next
        if scene == "ervoscene":
            a_c[0::2, 2] = 1.0
        u = torch.rand(n, generator=env_c.generator)
        adv_c, _, beeps = env_c.advance_fn(st_c, a_c, u)
        if peds:
            adv_g, _, _ = env_g.advance_fn(to_g(st_c), a_c.to(device),
                                           u.to(device))
            for f in ("pos", "vel"):
                d = float((getattr(adv_c.peds, f)
                           - getattr(adv_g.peds, f).cpu()).abs().max())
                worst["ped_" + f] = max(worst["ped_" + f], d)
            if not torch.equal(adv_c.peds.gait_state,
                               adv_g.peds.gait_state.cpu()):
                raise AssertionError("small config: gait phases differ")
            worst["beeps"] += int(beeps.sum())
        _, obs_g = env_g._observe(to_g(adv_c))
        st_c, obs_c = env_c._observe(adv_c)      # the CPU step
    if worst["actions"] > 1e-3:
        raise AssertionError(f"small config: card vs CPU {worst}")
    if peds:
        pos_tol, vel_tol = PED_TOL[scene]
        if worst["ped_pos"] > pos_tol or worst["ped_vel"] > vel_tol:
            raise AssertionError(f"small crowd config: card vs CPU {worst}")
        if scene == "ervoscene" and worst["beeps"] == 0:
            raise AssertionError("small ERVO config: no robot beeped")

    # the next episode, carrying the last state over
    sample, prev = env_c.sample_scenario(), st_c
    st_c, obs_c = env_c.reset(sample, carry=prev, dataset=dataset)
    st_g, obs_g = env_g.reset(on_g(sample), carry=to_g(prev),
                              dataset=dataset)
    for a, b in zip(world_state_to_numpy(st_c).peds,
                    world_state_to_numpy(st_g).peds):
        if not (a == b).all():
            raise AssertionError("small config: carried ped states differ")
    if not torch.equal(st_c.robots.vw_last1, st_g.robots.vw_last1.cpu()):
        raise AssertionError("small config: carried commands differ")
    check_obs(obs_c, obs_g)
    return worst


def scene_axis(state):
    """One scene's state as a batch of one."""
    from img_env_tpu_torch.core.state import map_tree

    return map_tree(lambda x: x[None], state)


def selfcheck_batches(batches, groups, fast, crowd):
    """The kernels against their twins at the shapes of the scene
    batches, the fast grid and the sensor groups.
    ``batches``: {name: (BatchedNavEnv, states)} of the multi-scene paths
    (K1 over their scene axis, reset and crowded poses); ``groups``,
    ``fast``: (NavEnv, state) of bench200 with sensor groups (K2 with each
    group's in-scene ids, K3 on each group's tables) and of fast bench200
    (K2, K3 and K5 on the fast grid's tables); ``crowd``: (NavEnv, state)
    of bench200ped, whose robots and peds give K4's input as 4 scenes of 50
    robots, each scene with its own 200 peds.  Returns {kernel: {case:
    ms}} of the timed cases."""
    from img_env_tpu_torch.env import observe
    from img_env_tpu_torch.ops import f32, painter, pedmap, polar, raster

    timed = {"raster": {}, "fill": {}, "paint": {}, "paint_block": {},
             "pedmap": {}}
    for name, (benv, states) in batches.items():
        core = benv.core
        t, res = core.tables, core.statics.resolution
        h, w = states.obs_map.shape[-2:]
        pose = states.robots.pose
        for case, p in (("reset poses", pose),
                        ("crowded poses", crowded_poses(
                            pose.reshape(-1, 3)).reshape(pose.shape))):
            cells = raster.world_to_cell(
                raster.transform_points(p, t.robot_points), res)
            got = raster.robot_maps_kernel(cells, t.robot_mask, h, w)
            want = raster.robot_maps_twin(cells, t.robot_mask, h, w)
            mism = int((got != want).sum())
            log(f"# K1 raster, {name} {case}: {mism} mismatched cells of "
                f"{got.numel()} ({got.shape[0]} scenes), max count "
                f"{int((got & 0xFFF).max())}")
            if mism:
                raise AssertionError(f"K1 raster kernel != twin ({name})")
        timed["raster"][name] = cuda_ms(lambda: raster.robot_maps_kernel(
            cells, t.robot_mask, h, w), 50)

    genv, gstate = groups
    packed = genv._layers(scene_axis(gstate)).packed
    for gi, (g, tg) in enumerate(zip(genv.statics.sensor_groups,
                                     genv.group_tables)):
        poses = gstate.robots.pose[tg.idx]
        sin, cos = f32.sin_cos(poses[:, 2])
        args = (packed, cos, sin, poses[:, 0].contiguous(),
                poses[:, 1].contiguous(), tg.polar.pix_x, tg.polar.pix_y,
                int(g.polar.n_fill_slots), genv.statics.resolution)
        occ = polar.fill_sorted_kernel(*args, rids=tg.rids)
        mism = int((occ != polar.fill_sorted_twin(*args,
                                                  rids=tg.rids)).sum())
        log(f"# K2 fill, bench200 sensor group {gi} (sensor {g.sensor}, "
            f"{len(g.idx)} robots, in-scene ids): {mism} mismatched slots "
            f"of {occ.numel()}")
        if mism:
            raise AssertionError("K2 fill kernel != twin (sensor group)")
        if gi == 0:
            timed["fill"]["bench200 group 0"] = cuda_ms(
                lambda: polar.fill_sorted_kernel(*args, rids=tg.rids), 20)
        _, _, aux = polar.raycast_batched(g.polar, tg.polar, occ)
        s_hit, s_tail = painter.hit_steps(g.painter, tg.painter, *aux)
        v_k = painter.paint_slots_kernel(tg.painter, s_hit, s_tail,
                                         g.painter.n_slots)
        mism = int((v_k != painter.paint_sorted(g.painter, tg.painter,
                                                s_hit, s_tail)).sum())
        log(f"# K3 paint, bench200 sensor group {gi}: {mism} mismatched "
            f"slots of {v_k.numel()}")
        if mism:
            raise AssertionError("K3 paint kernel != twin (sensor group)")

    fenv, fstate = fast
    fpacked = fenv._layers(scene_axis(fstate)).packed
    fargs = fill_args(fenv, fpacked, fstate.robots.pose)
    focc = check_fill(f"fast bench200 (view {fenv.statics.polar.params.hpx}"
                      f" px, P'={fenv.statics.polar.n_slots})", fargs)
    timed["fill"]["fast bench200"] = cuda_ms(
        lambda: polar.fill_sorted_kernel(*fargs), 20)
    ftb = block_tables(fenv)
    fs_hit, fs_tail = thresholds(fenv, focc)
    check_paint("fast bench200", fenv, fs_hit, fs_tail, ftb)
    pst, ft = fenv.statics.painter, fenv.tables.painter
    timed["paint"]["fast bench200"] = cuda_ms(
        lambda: painter.paint_slots_kernel(ft, fs_hit, fs_tail,
                                           pst.n_slots), 20)
    timed["paint_block"]["fast bench200"] = cuda_ms(
        lambda: painter.paint_blocks_kernel(ftb, fs_hit, fs_tail,
                                            pst.n_slots), 20)

    cenv, cstate = crowd
    pos = cstate.peds.pos
    gen = torch.Generator(device=pos.device)
    gen.manual_seed(1)
    vel = torch.rand(pos.shape, generator=gen, device=pos.device) * 2 - 1
    scenes = torch.stack([pos.roll(50 * k, 0) for k in range(4)])
    base = [x.reshape(200, -1) for x in observe.peds_in_base(
        cstate.robots.pose.reshape(4, 50, 3), scenes, vel.expand(4, -1, -1))]
    hs = int(cenv.cfg.ped_image_size[0])
    r_img = float(cenv.cfg.ped_image_r)
    got = pedmap.ped_map_kernel(*base, 6.0 / hs, r_img, hs)
    want = pedmap.ped_map_twin(*base, 6.0 / hs, r_img, hs)
    mism = int((got != want).sum())
    log(f"# K4 ped map, 4 scenes x 50 robots x 200 peds: {mism} mismatched "
        f"of {got.numel()}, {int((want[:, 0] > 0).sum())} occupied pixels")
    if mism:
        raise AssertionError("K4 ped-map kernel != twin (4 x 50)")
    timed["pedmap"]["4x50"] = cuda_ms(
        lambda: pedmap.ped_map_kernel(*base, 6.0 / hs, r_img, hs), 50)
    return timed


def device_profile(step, steps: int = 2):
    """(device operations, device busy ms) per call of ``step`` over
    ``steps`` calls under torch.profiler; (0, 0.0) when the profiler sees
    no device events."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return (len(dev) / steps,
            sum(e.time_range.elapsed_us() for e in dev) / 1e3 / steps)


def run_batch_path(benv, ctl, warmup: int, iters: int, per_step_expect,
                   never=()):
    """A scene batch's control loop: reset + ``warmup`` + ``iters`` control
    steps (the scene-batched act, then the batch step) with the launch
    counts set to 0 just before and read just after, host syncs made
    errors through every step; every step launches each kernel of
    ``per_step_expect`` exactly that many times (K1 once for all scenes,
    K2 and K3 once per sensor group) and none of ``never``; then device
    operations and busy ms per step over 2 profiled steps.  Returns
    (PathRun, ops per step, busy ms per step)."""
    from img_env_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    states, obs = benv.reset()
    at_reset = dict(kernels.LAUNCHES)
    states0 = states
    mss = ctl.init_scenes_state(states.obs_map.shape[0])
    checksum = torch.zeros((), dtype=torch.float64, device=benv.device)

    def control_step():
        nonlocal states, mss, obs
        before = dict(kernels.LAUNCHES)
        actions, mss, costs = ctl.act_scenes(states, mss)
        states, obs, *_ = benv.step(states, actions)
        checksum.add_(obs.sensor_maps.sum() + obs.lasers.sum()
                      + costs.sum())
        got = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
        bad = {k: got[k] for k in per_step_expect
               if got[k] != per_step_expect[k]}
        bad.update({k: got[k] for k in never if got[k]})
        if bad:
            raise AssertionError(f"a batch control step launched {bad}, "
                                 f"expected {per_step_expect}")

    torch.cuda.set_sync_debug_mode("error")
    for _ in range(warmup):
        control_step()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    for _ in range(iters):
        control_step()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / max(iters, 1) * 1e3
    launches = dict(kernels.LAUNCHES)
    per_step = {k: (v - at_reset[k]) / (warmup + iters)
                for k, v in launches.items()}
    ops, busy = device_profile(control_step)
    if not bool(torch.isfinite(checksum)):
        raise AssertionError("non-finite batch checksum")
    return (PathRun(states0, states, ms_step, launches, per_step,
                    float(checksum), obs, 0.0), ops, busy)


def small_batch_reference(cfg_dict, scenes: int, device):
    """A small config as a scene batch on the card vs the same batch on the
    CPU, from one set of layouts, one noise draw and one beep draw per
    step; each step observed from the CPU states on both devices (teacher
    forcing), the act compared on them too.  Collision and arrival codes,
    the ped surfaces, sensor maps and lasers exact (the kernels are
    bit-equal to their twins), actions within 1e-3.  Returns the
    worst differences."""
    from img_env_tpu_torch import BatchedNavEnv, EnvConfig, MpcController
    from img_env_tpu_torch import MppiConfig
    from img_env_tpu_torch.core.convert import (world_state_from_numpy,
                                                world_state_to_numpy)
    from img_env_tpu_torch.mpc.controller import MpcState

    cfg = EnvConfig.from_dict(cfg_dict)
    peds = cfg.ped_sim.total > 0
    n = cfg.robot.total
    env_c, env_g = BatchedNavEnv(cfg, "cpu"), BatchedNavEnv(cfg, device)
    ctl_c = MpcController(env_c.core, MppiConfig(horizon=H, samples=K))
    ctl_g = MpcController(env_g.core, MppiConfig(horizon=H, samples=K))
    to_g = lambda x: world_state_from_numpy(world_state_to_numpy(x), device)
    samples = [env_c.core.sample_scenario() for _ in range(scenes)]
    st_c, obs_c = env_c.reset(samples)
    _, obs_g = env_g.reset([type(x)(*(v.to(device) for v in x))
                            for x in samples])
    exact = ["sensor_maps", "lasers", "is_collisions", "is_arrives"] + (
        ["ped_maps", "ped_vector_states", "ped_min_dists"] if peds else [])
    worst = {"actions": 0.0}

    def check_obs(obs_c, obs_g):
        for f in exact:
            a = getattr(obs_c, f)
            if a.shape[:2] != (scenes, n):
                raise AssertionError(f"small batch: bad {f} {a.shape}")
            if not torch.equal(a, getattr(obs_g, f).cpu()):
                raise AssertionError(f"small batch: {f} differ")

    ms = ctl_c.init_scenes_state(scenes)
    for step in range(3):
        check_obs(obs_c, obs_g)
        noise = torch.randn((scenes, n, K, H, 2), generator=ctl_c.generator)
        a_c, ms_next, _ = ctl_c.act_scenes(st_c, ms, noise)
        a_g, _, _ = ctl_g.act_scenes(to_g(st_c),
                                     MpcState(ms.nominal.to(device)),
                                     noise.to(device))
        worst["actions"] = max(worst["actions"],
                               float((a_c - a_g.cpu()).abs().max()))
        ms = ms_next
        u = torch.rand((scenes, n), generator=env_c.core.generator)
        adv_c, _, _ = env_c.core.advance_scenes(st_c, a_c, u)
        _, obs_g = env_g.core.observe_scenes(to_g(adv_c))
        st_c, obs_c = env_c.core.observe_scenes(adv_c)
    check_obs(obs_c, obs_g)
    if worst["actions"] > 1e-3:
        raise AssertionError(f"small batch: card vs CPU {worst}")
    return worst


def load_stage5(device):
    """The stage-5 policy on ``device`` and its env config."""
    from img_env_tpu_torch import EnvConfig, load_policy_npz

    with open(POLICY_ENV, encoding="utf-8") as f:
        cfg = EnvConfig.from_dict(json.load(f))
    return load_policy_npz(POLICY_NPZ, cfg, device), cfg


def policy_inputs(cfg, obs):
    """The policy's inputs from a batch's Observation ([S, N, ...])."""
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    return (flat(obs.sensor_maps)[:, None], flat(obs.vector_states),
            flat(obs.ped_maps), flat(obs.ped_vector_states))


def check_policy(policy, cfg, obs):
    """(a) The forward on the card against the same module on the CPU, on
    the same observations; returns (worst error, card ms, CPU ms)."""
    import copy

    inputs = policy_inputs(cfg, obs)
    cpu = copy.deepcopy(policy).cpu()
    with torch.no_grad():
        got = policy(*inputs)
        want = cpu(*(x.cpu() for x in inputs))
    worst = 0.0
    for name, g, w in zip(("mean", "log_std", "value"), got, want):
        g, w = g.detach().cpu(), w.detach()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"policy {name}: non-finite on the card")
        err = float((g - w).abs().max())
        worst = max(worst, err)
        if not torch.allclose(g, w, rtol=POLICY_TOL, atol=POLICY_TOL):
            raise AssertionError(f"policy {name}: card vs CPU {err}")

    def forward():
        with torch.no_grad():
            policy(*inputs)

    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(3):
            cpu(*(x.cpu() for x in inputs))
    cpu_ms = (time.perf_counter() - t0) / 3 * 1e3
    # 5 calls: their host enqueue (~2 ms a call) stays under the sleep
    return worst, cuda_ms(forward, 5), cpu_ms


def selfcheck_eval(benv, states, name="eval bank50"):
    """K1-K4 against their twins at the shapes of a path of S scenes of one
    robot (the evaluation, training and BARN paths: K1 over S maps, K2
    with one robot a scene, K3 on its thresholds, K4 over the S robots and
    their scenes' peds where there are peds); returns {kernel: ms}."""
    from img_env_tpu_torch.env import observe
    from img_env_tpu_torch.ops import pedmap, polar, raster

    core = benv.core
    t, res = core.tables, core.statics.resolution
    h, w = states.obs_map.shape[-2:]
    pose = states.robots.pose
    cells = raster.world_to_cell(raster.transform_points(pose, t.robot_points),
                                 res)
    got = raster.robot_maps_kernel(cells, t.robot_mask, h, w)
    mism = int((got != raster.robot_maps_twin(cells, t.robot_mask, h,
                                              w)).sum())
    log(f"# K1 raster, {name}: {mism} mismatched cells of "
        f"{got.numel()} ({got.shape[0]} scenes)")
    if mism:
        raise AssertionError(f"K1 raster kernel != twin ({name})")
    ms = {"raster": cuda_ms(lambda: raster.robot_maps_kernel(
        cells, t.robot_mask, h, w), 50)}
    packed = core._layers(states).packed
    poses = pose.reshape(-1, 3)
    args = fill_args(core, packed, poses, pose.shape[1])
    occ = check_fill(name, args)
    ms["fill"] = cuda_ms(lambda: polar.fill_sorted_kernel(*args), 20)
    s_hit, s_tail = thresholds(core, occ)
    check_paint(name, core, s_hit, s_tail)
    from img_env_tpu_torch.ops import painter

    pst, pt = core.statics.painter, core.tables.painter
    ms["paint"] = cuda_ms(lambda: painter.paint_slots_kernel(
        pt, s_hit, s_tail, pst.n_slots), 20)
    m = states.peds.pos.shape[1]
    if m == 0:          # no peds (BARN): K4 has no input
        return ms
    base = [x.reshape(-1, m) for x in observe.peds_in_base(
        pose, states.peds.pos, states.peds.vel)]
    hs, r_img = int(core.cfg.ped_image_size[0]), float(core.cfg.ped_image_r)
    got = pedmap.ped_map_kernel(*base, 6.0 / hs, r_img, hs)
    want = pedmap.ped_map_twin(*base, 6.0 / hs, r_img, hs)
    mism = int((got != want).sum())
    log(f"# K4 ped map, {name} ({base[0].shape[0]} robots x {m} "
        f"peds): {mism} mismatched of {got.numel()}, "
        f"{int((want[:, 0] > 0).sum())} occupied pixels")
    if mism:
        raise AssertionError(f"K4 ped-map kernel != twin ({name})")
    ms["pedmap"] = cuda_ms(lambda: pedmap.ped_map_kernel(
        *base, 6.0 / hs, r_img, hs), 50)
    return ms


class CountingPolicy:
    """A policy_fn that counts its calls (one per control step), reads the
    launch counts at its first call (what the reset launched) and sums its
    own host time, synchronised (the evaluator syncs every step anyway)."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0
        self.at_first = None
        self.t_first = 0.0
        self.seconds = 0.0

    def __call__(self, generator, obs):
        from img_env_tpu_torch.ops import kernels

        if self.calls == 0:
            torch.cuda.synchronize()
            self.at_first = dict(kernels.LAUNCHES)
            self.t_first = time.perf_counter()
        self.calls += 1
        t0 = time.perf_counter()
        out = self.fn(generator, obs)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        return out


def eval_path(policy, cfg):
    """(b) The trusted evaluator at full width: ``evaluate_batched`` of the
    stage-5 policy over the bank's 50 episodes, one scene each, on the
    card, the launch counts set to 0 just before and read just after.
    Then, from the reset of the same bank, profiled steps of the same loop
    (policy, step, the evaluator's host reads; host syncs made errors in
    the policy and the step), the crowd alone, and K1-K4 against their
    twins on the stepped states.  Returns a dict of what it measured."""
    from img_env_tpu_torch import BatchedNavEnv, ScenarioBank, evaluate_batched
    from img_env_tpu_torch import mean_action_fn
    from img_env_tpu_torch.core.state import map_tree
    from img_env_tpu_torch.ops import kernels

    bank = ScenarioBank.load(BANK50)
    fn = CountingPolicy(mean_action_fn(policy, cfg))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary, dones = evaluate_batched(cfg, fn, EVAL_EPISODES, bank=bank)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    steps = fn.calls
    per_step = {k: (launches[k] - fn.at_first[k]) / steps for k in launches}
    loop_s = t_end - fn.t_first
    out = dict(summary=summary, dones=dones, steps=steps,
               wall_s=t_end - t0, ms_step=loop_s / steps * 1e3,
               policy_share=fn.seconds / loop_s, launches=launches,
               at_reset=fn.at_first, per_step=per_step)
    if dones.shape != (EVAL_EPISODES, cfg.robot.total):
        raise AssertionError(f"eval: dones_info shape {dones.shape}")
    if not set(np.unique(dones).tolist()) <= {1, 2, 3, 5, 10}:
        raise AssertionError(f"eval: labels {np.unique(dones)}")
    for k in ("raster", "fill", "paint", "pedmap"):
        if per_step[k] != 1.0:
            raise AssertionError(f"eval: {k} launched {per_step[k]} times "
                                 f"a step, not once")
    if launches["paint_block"]:
        raise AssertionError("eval: K5 launched")

    benv = BatchedNavEnv(cfg)
    spec = benv.core.statics.sampler
    states, obs = benv.reset([bank.sample(e, spec, benv.device)
                              for e in range(EVAL_EPISODES)])
    out["policy_check"] = check_policy(policy, cfg, obs)
    policy_fn = mean_action_fn(policy, cfg)

    def control_step():
        nonlocal states, obs
        torch.cuda.set_sync_debug_mode("error")
        a = policy_fn(None, obs)
        a = torch.cat([a, a.new_zeros(a.shape[:-1] + (1,))], -1)
        states, obs, *_ = benv.step(states, a)
        torch.cuda.set_sync_debug_mode(0)
        for x in (obs.is_collisions, obs.is_arrives, obs.ped_min_dists):
            x.cpu()

    for _ in range(3):
        control_step()
    out["ops"], out["busy_ms"] = device_profile(control_step)
    out["idle_share"] = 1.0 - out["busy_ms"] / out["ms_step"]
    core = benv.core
    n = cfg.robot.total

    def crowd_only():
        for k in range(EVAL_EPISODES):
            core._crowd_step(map_tree(lambda x, k=k: x[k], states),
                             None, None)

    out["crowd_ops"], out["crowd_busy_ms"] = device_profile(crowd_only)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        crowd_only()
    torch.cuda.synchronize()
    out["crowd_host_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    out["policy_ops"], out["policy_busy_ms"] = device_profile(
        lambda: policy_fn(None, obs))
    if n != 1:
        raise AssertionError("eval: the stage-5 config has one robot")
    out["kernel_ms"] = selfcheck_eval(benv, states)
    return out


def small_eval_reference(device):
    """(c) The small evaluator config on the card vs the CPU port, with the
    exact P-controller (multiplies and clips): ``make_env`` with its
    wrapper stack for one episode (one bank episode on both), then
    ``evaluate_batched`` of 3 episodes with ``record=True``.  Filtered
    observations, rewards, dones, ``dones_info``, ``all_down``, the
    summary (its wall time aside) and the recorder's poses must be equal.
    Returns the steps the facade ran."""
    from img_env_tpu_torch import EnvConfig, evaluate_batched, make_env

    def p_control(generator, obs):
        vec = obs.vector_states
        return torch.stack([torch.clamp(0.8 * vec[..., 0], 0.0, 0.6),
                            torch.clamp(2.0 * vec[..., 1], -0.9, 0.9)], -1)

    d = dict(SMALL_EVAL, cfg_type="bag", init_pose_bag_episodes=1)
    env_c, env_g = make_env(d, device="cpu"), make_env(d, device=device)
    obs_c, obs_g = env_c.reset(carry=False), env_g.reset(carry=False)
    steps = 0
    for _ in range(SMALL_EVAL["time_max"] + 1):
        for a, b in zip(obs_c, obs_g):
            if not np.array_equal(a, b):
                raise AssertionError("small eval: facade observations "
                                     "differ")
        act = p_control(None, env_c.last_raw_obs).numpy()
        obs_c, r_c, d_c, i_c = env_c.step(act)
        obs_g, r_g, d_g, i_g = env_g.step(act)
        steps += 1
        for name, a, b in (("reward", r_c, r_g), ("done", d_c, d_g),
                           *((k, i_c[k], i_g[k]) for k in i_c)):
            if not np.array_equal(a, b):
                raise AssertionError(f"small eval: facade {name} differ")
        if bool(i_c["all_down"]):
            break
    cfg = EnvConfig.from_dict(SMALL_EVAL)
    runs = [evaluate_batched(cfg, p_control, 3, record=True, device=dev)
            for dev in ("cpu", device)]
    (s_c, di_c, rec_c), (s_g, di_g, rec_g) = runs
    s_c.pop("wall_s"), s_g.pop("wall_s")
    if not np.array_equal(di_c, di_g) or s_c != s_g:
        raise AssertionError(f"small eval: evaluator {s_c} vs {s_g}")
    for ec, eg in zip(rec_c.episodes, rec_g.episodes):
        for k in ("robot_poses", "robot_vws"):
            if not np.array_equal(ec.arrays()[k], eg.arrays()[k]):
                raise AssertionError(f"small eval: recorder {k} differ")
    return steps, s_g


def to_device(sample, device):
    return type(sample)(*(v.to(device) for v in sample))


def small_train_reference(device):
    """(a) One train step of a small crowd config (SMALL_PED, 2 scenes,
    unroll 4, 2 epochs x 2 minibatches, clip 0.5 + sgd 0.05) on the card
    and on the CPU from one fresh policy, one set of layouts and the same
    injected draws (Gaussian noise, reset layouts, permutations); scene 0
    starts 2 steps before time_max, so the autoreset redraws it.  Done
    codes, the final collision and arrival codes, the step counts and the
    scenes reset must be equal, the parameters within STEP_TOL.  Returns
    (worst parameter error, how far they moved, scenes reset)."""
    from img_env_tpu_torch import BatchedNavEnv, EnvConfig
    from img_env_tpu_torch.models.policy import (CrowdNavPolicy, PolicyConfig,
                                                 init_policy)
    from img_env_tpu_torch.train import optim, ppo

    cfg = EnvConfig.from_dict(SMALL_PED)
    s, t, epochs = 2, 4, 2
    pcfg = ppo.PpoConfig(unroll=t, epochs=epochs, minibatches=2,
                         reward_scale=0.02)
    gen = torch.Generator().manual_seed(0)
    pol_cfg = PolicyConfig.from_env_config(cfg)
    _, params0 = init_policy(gen, pol_cfg, "cpu")
    env_c = BatchedNavEnv(cfg, "cpu")
    samples = [env_c.core.sample_scenario() for _ in range(2 * s)]
    b = s * cfg.robot.total
    eps = torch.randn((t, b, cfg.act_dim), generator=gen)
    perms = torch.stack([torch.randperm(t * b, generator=gen)
                         for _ in range(epochs)])
    out = {}
    for dev in ("cpu", device):
        env = env_c if dev == "cpu" else BatchedNavEnv(cfg, dev)
        params = {k: v.to(dev) for k, v in params0.items()}
        init_fn, step = ppo.make_train_step(
            env, CrowdNavPolicy(pol_cfg).to(dev), pcfg,
            tx=optim.chain(optim.clip_by_global_norm(0.5), optim.sgd(0.05)))
        states, obs = env.reset([to_device(x, dev) for x in samples[:s]])
        states = states._replace(step=torch.tensor(
            [cfg.time_max - 2, 0], dtype=torch.int32, device=dev))
        draws = ppo.Draws(eps.to(dev), [to_device(x, dev)
                                        for x in samples[s:]], perms.to(dev))
        traj = step.rollout(params, states, obs, None, draws.eps)[2]
        ts, states, obs, m = step(init_fn(params), states, obs, None, draws)
        out[dev] = (torch.stack([x[5] for x in traj]).cpu(), ts, states, m)
    (done_c, ts_c, st_c, m_c), (done_g, ts_g, st_g, m_g) = (out["cpu"],
                                                            out[device])
    if not torch.equal(done_c, done_g):
        raise AssertionError("train step: done codes differ card vs CPU")
    for f in ("collision", "arrive"):
        if not torch.equal(getattr(st_c.robots, f),
                           getattr(st_g.robots, f).cpu()):
            raise AssertionError(f"train step: final {f} codes differ")
    if (not torch.equal(st_c.step, st_g.step.cpu())
            or m_c["reset_scenes"] != m_g["reset_scenes"]
            or m_c["reset_scenes"] < 1):
        raise AssertionError("train step: the autoreset differs")
    worst = max(float((ts_g.params[k].cpu() - v).abs().max())
                for k, v in ts_c.params.items())
    moved = max(float((ts_c.params[k] - v).abs().max())
                for k, v in params0.items())
    if not worst <= STEP_TOL or not moved > 100 * STEP_TOL:
        raise AssertionError(f"train step: parameters card vs CPU {worst} "
                             f"(moved {moved})")
    return worst, moved, m_c["reset_scenes"]


def check_train_gradients(model, params, mb, pcfg):
    """(b) The loss and every gradient leaf of one minibatch at full width
    on the card (``loss_and_grads``: TF32 off in the forward and the
    backward) against the same on the CPU, under torch's default TF32
    flags, each leaf within the error model (``ppo.grad_error_ratios``
    over ``ppo.grad_term_sums`` on the card); then the control, a bare
    ``loss.backward()`` outside the guard, which the tolerance must catch.
    Returns (loss error, worst ratio, control's worst ratio, card ms, CPU
    ms, the worst leaf, pi_mean.bias's and value.bias's gradient and
    largest term sum)."""
    import copy

    from img_env_tpu_torch.train import ppo

    loss_g, _, grads_g = ppo.loss_and_grads(model, params, mb, pcfg)
    cpu = lambda x: None if x is None else x.cpu()
    mb_c = (tuple(cpu(f) for f in mb[0]), *(cpu(x) for x in mb[1:]))
    params_c = {k: v.cpu() for k, v in params.items()}
    model_c = copy.deepcopy(model).cpu()
    t0 = time.perf_counter()
    loss_c, _, grads_c = ppo.loss_and_grads(model_c, params_c, mb_c, pcfg)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    loss_err = abs(float(loss_g) - float(loss_c))
    if not loss_err <= 1e-4 * abs(float(loss_c)):
        raise AssertionError(f"train gradients: loss {float(loss_g)} vs "
                             f"{float(loss_c)}")
    sums = ppo.grad_term_sums(model, params, mb, pcfg)
    ratios = ppo.grad_error_ratios(grads_g, grads_c, sums)
    worst = max(ratios.values())
    if not worst <= 1.0:
        bad = {k: r for k, r in ratios.items() if r > 1.0}
        raise AssertionError(f"train gradients: card vs CPU beyond "
                             f"tolerance {bad}")
    # the control: the same forward, backward outside the guard
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, _ = ppo.minibatch_loss(model, p, mb, pcfg)
    loss.backward()
    control = max(ppo.grad_error_ratios({k: v.grad for k, v in p.items()},
                                        grads_c, sums).values())
    if not control > 1.0:
        raise AssertionError(f"train gradients: the unguarded backward "
                             f"(TF32 on for cuDNN) is within the tolerance "
                             f"({control}): it would not catch TF32")
    card_ms = cuda_ms(lambda: ppo.loss_and_grads(model, params, mb, pcfg), 5)
    leaves = {k: (float(grads_c[k].abs().max()), float(sums[k].max()))
              for k in ("pi_mean.bias", "value.bias")}
    return (loss_err, worst, control, card_ms, cpu_ms,
            max(ratios, key=ratios.get), leaves)


class StepCounter:
    """Counts the env steps and resets of ``BatchedNavEnv`` while active and
    checks that every env step launches each of ``once`` exactly once and
    none of ``never`` (host-side counters: no sync)."""

    def __init__(self, once, never):
        self.once, self.never = once, never
        self.steps = self.resets = 0
        self.step_launches = None

    def __enter__(self):
        from img_env_tpu_torch import BatchedNavEnv
        from img_env_tpu_torch.ops import kernels

        self.cls = BatchedNavEnv
        # every reset, the autoreset's partial ones too, goes through
        # reset_local
        self.orig = (BatchedNavEnv.step, BatchedNavEnv.reset_local)
        step, reset = self.orig

        def counted_step(env, *a, **kw):
            before = dict(kernels.LAUNCHES)
            out = step(env, *a, **kw)
            got = {k: kernels.LAUNCHES[k] - before[k] for k in before}
            if (any(got[k] != 1 for k in self.once)
                    or any(got[k] for k in self.never)):
                raise AssertionError(f"an env step launched {got}")
            self.steps += 1
            self.step_launches = {k: v + (self.step_launches or {}).get(k, 0)
                                  for k, v in got.items()}
            return out

        def counted_reset(env, *a, **kw):
            self.resets += 1
            return reset(env, *a, **kw)

        BatchedNavEnv.step, BatchedNavEnv.reset_local = (counted_step,
                                                         counted_reset)
        return self

    def __exit__(self, *exc):
        self.cls.step, self.cls.reset_local = self.orig


def train_path():
    """(c) The stage-5 continuation at full width through train/run.py's
    code path (TRAIN_ARGS): launch counts set to 0 just before and read
    just after, K1-K4 once per env step and K5 never, the loss finite, the parameters moved, the mean
    reward_mean at least REWARD_FLOOR, a checkpoint round trip; then an
    unroll with host syncs made errors, whose samples give (b); device
    operations and busy ms per env step and per update, the crowd's share;
    K1-K4 against their twins at these shapes.  Returns what it
    measured."""
    import tempfile

    from img_env_tpu_torch.core.state import map_tree
    from img_env_tpu_torch.models.policy import load_ckpt_policy
    from img_env_tpu_torch.ops import kernels
    from img_env_tpu_torch.train import checkpoint, ppo, run
    from torch.func import functional_call

    args = run.parse_args(TRAIN_ARGS)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    lines = []
    t0 = time.perf_counter()
    with StepCounter(("raster", "fill", "paint", "pedmap"),
                     ("paint_block",)) as counter:
        res = run.train(args, log=lines.append)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for line in lines:
        log(f"# train stage5: {line}")
    env, ts, cfg = res["env"], res["ts"], res["env"].cfg
    s, n = args.scenes, cfg.robot.total
    steps = counter.steps
    if steps != TRAIN_UPDATES * args.unroll:
        raise AssertionError(f"train stage5: {steps} env steps")
    for k in ("raster", "fill", "paint", "pedmap"):
        if launches[k] != steps + counter.resets:
            raise AssertionError(f"train stage5: {k} launched "
                                 f"{launches[k]} times in {steps} steps and "
                                 f"{counter.resets} resets")
    if launches["paint_block"]:
        raise AssertionError("train stage5: K5 launched")
    for m in res["metrics"]:
        if not all(bool(torch.isfinite(torch.as_tensor(m[k])))
                   for k in ("loss", "pg_loss", "vf_loss", "entropy")):
            raise AssertionError(f"train stage5: non-finite metrics {m}")
    hist = res["history"]
    reward_mean = float(hist[:, 1].mean())
    if reward_mean < REWARD_FLOOR:
        raise AssertionError(f"train stage5: mean reward_mean "
                             f"{reward_mean} < {REWARD_FLOOR}")
    start = run.restore_params(POLICY_NPZ, ts.params)
    moved = max(float((ts.params[k] - v).abs().max())
                for k, v in start.items() if k != "pi_log_std")
    if not moved > 0:
        raise AssertionError("train stage5: the parameters did not move")
    with tempfile.TemporaryDirectory() as tmp:
        path = tmp + "/stage5_train.pt"
        checkpoint.save(path, {"ts": ts})
        back = checkpoint.restore(path, like={"ts": ts},
                                  device=env.device)["ts"]
        leaves = lambda t: [t.step, *t.params.values(),
                            *t.opt_state[1][0].mu.values(),
                            *t.opt_state[1][0].nu.values(),
                            t.opt_state[1][0].count]
        if not all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                     leaves(ts))):
            raise AssertionError("train stage5: checkpoint round trip")
        checkpoint.save(path, {"params": ts.params})
        policy_fn, _ = load_ckpt_policy(cfg, path, env.device)
        act = policy_fn(None, res["obs"])
        if act.shape != (s, n, cfg.act_dim) or not bool(
                torch.isfinite(act).all()):
            raise AssertionError("train stage5: load_ckpt_policy")

    # an unroll with host syncs made errors; its samples give (b)
    model, step_fn, gen = res["model"], res["train_step"], res["generator"]
    states, obs = res["states"], res["obs"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    states_r, obs_r, traj = step_fn.rollout(ts.params, states, obs, gen,
                                            None)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"# train stage5: an unroll of {args.unroll} steps with host syncs "
        f"made errors, {time.perf_counter() - t0:.3f} s")
    pcfg = ppo.PpoConfig(unroll=args.unroll, lr=args.lr, epochs=args.epochs,
                         minibatches=args.minibatches,
                         ent_coef=args.ent_coef,
                         reward_scale=args.reward_scale)
    with torch.no_grad():
        last_value = functional_call(model, ts.params, ppo.obs_features(
            obs_r, True))[-1]
    data, _ = ppo.rollout_data(traj, last_value, pcfg)
    idx = torch.randperm(data[1].shape[0], generator=gen,
                         device=gen.device)[:GRAD_SAMPLES]
    grads = check_train_gradients(model, ts.params, ppo.take(data, idx),
                                  pcfg)

    # device operations and busy ms of an update, composed from one update
    # of trainers with unroll 1 and 2 at the same shapes, the autoreset off
    # (a profile of a whole update would record ~400,000 events): a rollout
    # step (policy forward, draw, env step, reward) is their difference,
    # the rest (the last value, GAE, 4 minibatch forwards, backwards and
    # optimizer steps) the unroll-1 update less one rollout step
    t_prof = time.perf_counter()
    prof = {}
    for unroll in (1, 2):
        _, step_u = ppo.make_train_step(env, model, pcfg._replace(
            unroll=unroll, autoreset=False))
        step_u(ts, states, obs, gen)                  # warm-up
        prof[unroll] = device_profile(lambda: step_u(ts, states, obs, gen),
                                      steps=1)
    roll_ops = prof[2][0] - prof[1][0]
    roll_busy = prof[2][1] - prof[1][1]
    upd_ops = prof[1][0] + (args.unroll - 1) * roll_ops
    upd_busy = prof[1][1] + (args.unroll - 1) * roll_busy
    zero = torch.zeros((s, n, 3), device=env.device)
    step_ops, step_busy = device_profile(lambda: env.step(states, zero),
                                         steps=1)
    core = env.core

    def crowd_only():
        for k in range(s):
            core._crowd_step(map_tree(lambda x, k=k: x[k], states),
                             None, None)

    crowd_ops, crowd_busy = device_profile(crowd_only, steps=1)
    t_prof = time.perf_counter() - t_prof
    kernel_ms = selfcheck_eval(env, states, "train stage5")
    tim = res["timings"]
    per_update = [sum(x.values()) for x in tim]
    return dict(
        lines=lines, wall=wall, launches=launches, steps=steps,
        unroll=args.unroll,
        resets=counter.resets, peak=peak, hist=hist,
        reward_mean=reward_mean, moved=moved, timings=tim,
        s_update=float(np.mean(per_update)),
        rate=steps * s * n / sum(per_update),
        per_step={k: v / steps for k, v in counter.step_launches.items()},
        reset_scenes=[m["reset_scenes"] for m in res["metrics"]],
        grads=grads, step_ops=step_ops, step_busy=step_busy,
        roll_ops=roll_ops, roll_busy=roll_busy, upd_ops=upd_ops,
        upd_busy=upd_busy, opt_ops=prof[1][0] - roll_ops,
        opt_busy=prof[1][1] - roll_busy, crowd_ops=crowd_ops,
        crowd_busy=crowd_busy, kernel_ms=kernel_ms, t_prof=t_prof)


def report_train(tr) -> None:
    """Logs what ``train_path`` measured."""
    from img_env_tpu_torch.train import ppo

    tim = tr["timings"]
    mean_t = {k: float(np.mean([x[k] for x in tim])) for k in tim[0]}
    ms_env_step = mean_t["rollout"] / tr["unroll"] * 1e3
    (loss_err, g_worst, g_control, g_card_ms, g_cpu_ms, g_leaf,
     g_leaves) = tr["grads"]
    log(f"# train stage5 (32 scenes x 1 robot, unroll 16, 2 x 2 "
        f"minibatches, {TRAIN_UPDATES} updates): {tr['wall']:.3f} s wall "
        f"with the set-up; s per update {tr['s_update']:.3f} (rollout "
        f"{mean_t['rollout']:.3f}, autoreset {mean_t['autoreset']:.3f}, "
        f"update {mean_t['update']:.3f}); each update "
        + "; ".join(f"{x['rollout']:.3f} / {x['autoreset']:.3f} / "
                    f"{x['update']:.3f}" for x in tim)
        + f"; {tr['rate']:.1f} robot-steps/s; {ms_env_step:.3f} ms per env "
        f"step in the rollout (host's clock)")
    log(f"# train stage5 device: per env step {tr['step_ops']:.1f} "
        f"operations, {tr['step_busy']:.4f} ms busy, the crowd alone (32 SFM "
        f"scene steps) {tr['crowd_ops']:.1f} operations "
        f"({tr['crowd_ops'] / max(tr['step_ops'], 1):.4f} of the step's), "
        f"{tr['crowd_busy']:.4f} ms busy; per rollout step (policy, draw, "
        f"env step, reward) {tr['roll_ops']:.1f} operations, "
        f"{tr['roll_busy']:.4f} ms busy, idle share "
        f"{1 - tr['roll_busy'] / ms_env_step:.4f}; the update's "
        f"optimization (last value, GAE, 4 minibatches) "
        f"{tr['opt_ops']:.1f} operations, {tr['opt_busy']:.4f} ms busy; "
        f"per update {tr['upd_ops']:.1f} operations, {tr['upd_busy']:.4f} "
        f"ms busy, idle share "
        f"{1 - tr['upd_busy'] / (tr['s_update'] * 1e3):.4f} (profiles "
        f"{tr['t_prof']:.1f} s); peak memory {tr['peak']:.3f} GiB")
    log(f"# train stage5 curve: reward_mean "
        f"{[round(float(x), 4) for x in tr['hist'][:, 1]]}, arrive "
        f"{[float(x) for x in tr['hist'][:, 2]]}, collision "
        f"{[float(x) for x in tr['hist'][:, 3]]}, mean reward_mean "
        f"{tr['reward_mean']:.4f} (floor {REWARD_FLOOR}); scenes reset "
        f"{tr['reset_scenes']}; {tr['steps']} env steps and {tr['resets']} "
        f"resets launched {tr['launches']}; params moved {tr['moved']:.4g}")
    log(f"# train stage5 gradients ({GRAD_SAMPLES} samples) card vs CPU: "
        f"loss within {loss_err:.3g}, worst leaf {g_leaf} at "
        f"{g_worst:.4f} of its tolerance ({ppo.GRAD_REL} of the leaf's "
        f"largest sum of per-sample term magnitudes + {ppo.GRAD_ABS}); "
        f"(largest |gradient|, largest term sum) {g_leaves}; the "
        f"unguarded backward (TF32 on for cuDNN) at {g_control:.2f} of it; "
        f"loss and gradients {g_card_ms:.4f} ms on the card, "
        f"{g_cpu_ms:.3f} ms on the CPU; kernel ms at these shapes "
        f"{tr['kernel_ms']}")

def easy_train_path():
    """(d) Learning from scratch: README.md:101-104's settings on
    easy_train.yaml's config (EASY_ARGS) through train/run.py, once for
    each of EASY_SEEDS.  The mean over the runs of their last-10 mean
    reward_mean must exceed that of their first-10 means.  Returns (the
    curves [runs, updates], wall s)."""
    from img_env_tpu_torch import EnvConfig
    from img_env_tpu_torch.train import run

    t0 = time.perf_counter()
    curves = []
    for seed in EASY_SEEDS:
        args = list(EASY_ARGS)
        args[args.index("--seed") + 1] = str(seed)
        res = run.train(run.parse_args(args),
                        cfg=EnvConfig.from_dict(EASY_TRAIN),
                        log=lambda s: None)
        curves.append(res["history"][:, 1])
    wall = time.perf_counter() - t0
    curves = np.stack(curves)
    first, last = curves[:, :10].mean(), curves[:, -10:].mean()
    if not last > first:
        raise AssertionError(f"easy train: last-10 mean {last} against "
                             f"first-10 {first}; curves {curves.tolist()}")
    return curves, wall


# ---- phase 14: the rest of the MPC engine (LQT, iLQR, CEM, the geodesic
# goal field) and the BARN benchmark ----

LQT_ROBOTS = 200            # one LQT problem per bench200 robot
LQT_TOL_F32 = 1e-4          # float32, of each output's largest entry
SMALL_MPC_TOL = 1e-3        # small iLQR and CEM, card vs CPU actions; costs
                            # rtol 1e-4 (float32 transcendentals differ)
ILQR_WARMUP = 2
ILQR_STEPS = 5              # timed iLQR control steps at bench200
BARN_WORLDS = 100           # worlds 0-99: the protocol's first chunk
BARN_EPISODES = 3
BARN_MAX_STEPS = 150
BARN_ARRIVE_FLOOR = 0.95    # the JAX protocol's 0.9944 less ~10 binomial
                            # sigma at 300 episodes
BARN_STATIC_COLL_CEIL = 0.02


def lqt_problems(dtype, robots: int = LQT_ROBOTS, h: int = 12, n: int = 3,
                 m: int = 2, seed: int = 14):
    """Random LQT problems, one per robot, as tests/test_lqr.py draws them
    (numpy from a seed)."""
    from img_env_tpu_torch.mpc import lqr

    rng = np.random.default_rng(seed)

    def psd(k, *batch):
        a = rng.normal(size=batch + (k, k))
        return a @ np.swapaxes(a, -1, -2) + k * np.eye(k)

    arrays = (rng.normal(size=(robots, h, n, n)) * 0.4 + np.eye(n),
              rng.normal(size=(robots, h, n, m)),
              rng.normal(size=(robots, h, n)) * 0.1,
              psd(n, robots, h) * 0.1, rng.normal(size=(robots, h, n)) * 0.1,
              psd(m, robots, h), rng.normal(size=(robots, h, m)) * 0.1,
              psd(n, robots), rng.normal(size=(robots, n)))
    return lqr.LqtProblem(*(torch.as_tensor(a.astype(dtype))
                            for a in arrays))


def lqt_check(device="cuda"):
    """(14a) ``lqt_backward_assoc`` against ``lqt_backward_seq`` on the
    card, and the card against the CPU port, on 200 robots' problems (H =
    12, n = 3, m = 2): float64 to tests/test_lqr.py's 1e-8, float32 to
    LQT_TOL_F32 of each output's largest entry.  Returns worst errors,
    times and device operations."""
    from img_env_tpu_torch.mpc import lqr

    out = {}
    for name, dtype in (("f64", np.float64), ("f32", np.float32)):
        p_c = lqt_problems(dtype)
        p_g = lqr.LqtProblem(*(x.to(device) for x in p_c))
        seq_g = lqr.lqt_backward_seq(p_g)
        assoc_g = lqr.lqt_backward_assoc(p_g)
        assoc_c = lqr.lqt_backward_assoc(p_c)
        worst = {"assoc vs seq": 0.0, "card vs cpu": 0.0}
        for a, b, c in zip(assoc_g, seq_g, assoc_c):
            a, b, c = a.cpu().double(), b.cpu().double(), c.double()
            if dtype == np.float64:
                ok = (bool(torch.allclose(a, b, rtol=1e-8, atol=1e-8))
                      and bool(torch.allclose(a, c, rtol=1e-8, atol=1e-8)))
                scale = 1.0
            else:
                scale = float(c.abs().max())
                ok = max(float((a - b).abs().max()),
                         float((a - c).abs().max())) <= LQT_TOL_F32 * scale
            worst["assoc vs seq"] = max(worst["assoc vs seq"],
                                        float((a - b).abs().max()) / scale)
            worst["card vs cpu"] = max(worst["card vs cpu"],
                                       float((a - c).abs().max()) / scale)
            if not ok:
                raise AssertionError(f"LQT {name}: {worst}")
        worst["assoc ms"] = cuda_ms(lambda: lqr.lqt_backward_assoc(p_g), 5)
        worst["seq ms"] = cuda_ms(lambda: lqr.lqt_backward_seq(p_g), 5)
        worst["assoc ops"], _ = device_profile(
            lambda: lqr.lqt_backward_assoc(p_g))
        out[name] = worst
    return out


def small_mpc_reference(device="cuda"):
    """(14b) ``MpcController(method='ilqr').act_fn`` on SMALL's config from
    one reset state, card vs CPU (iLQR draws nothing), and ``cem_plan`` for
    robot 0 on injected draws; actions within SMALL_MPC_TOL, costs within
    rtol 1e-4.  Returns the worst differences."""
    from img_env_tpu_torch import EnvConfig, MpcController, MppiConfig, NavEnv
    from img_env_tpu_torch.core.convert import (world_state_from_numpy,
                                                world_state_to_numpy)
    from img_env_tpu_torch.mpc import mppi
    from img_env_tpu_torch.mpc.controller import MpcState

    cfg = EnvConfig.from_dict(SMALL)
    env_c, env_g = NavEnv(cfg, "cpu"), NavEnv(cfg, device)
    mcfg = MppiConfig(horizon=H, samples=K)
    ctl_c = MpcController(env_c, mcfg, method="ilqr")
    ctl_g = MpcController(env_g, mcfg, method="ilqr")
    st_c, _ = env_c.reset()
    st_g = world_state_from_numpy(world_state_to_numpy(st_c), device)
    ms = ctl_c.init_state()
    a_c, ms_c, c_c = ctl_c.act_fn(st_c, ms)
    a_g, ms_g, c_g = ctl_g.act_fn(st_g, MpcState(ms.nominal.to(device)))
    worst = {"ilqr actions": float((a_c - a_g.cpu()).abs().max()),
             "ilqr plan": float((ms_c.nominal - ms_g.nominal.cpu()).abs()
                                .max()),
             "ilqr cost rel": float(((c_c - c_g.cpu()) / c_c).abs().max()),
             "ilqr moved": float(a_c[:, :2].abs().max())}
    gen = torch.Generator().manual_seed(14)
    noise = torch.randn((mcfg.cem_iters, K, H, 2), generator=gen)
    outs = []
    for env_x, ctl_x, st_x in ((env_c, ctl_c, st_c), (env_g, ctl_g, st_g)):
        wc = ctl_x.world_cost(scene_axis(st_x))
        wc = wc._replace(scene=wc.scene[:1])
        r = st_x.robots
        outs.append(mppi.cem_plan(
            noise.to(env_x.device), mppi.init_planner(mcfg, env_x.device),
            r.pose[0], r.vw_last0[0], r.vw_last1[0], r.goal[0], wc,
            env_x.statics.limiter_v, env_x.statics.limiter_w,
            torch.zeros((H, 0, 2), device=env_x.device),
            torch.zeros(0, device=env_x.device), mcfg))
    worst["cem action"] = float((outs[0][0] - outs[1][0].cpu()).abs().max())
    worst["cem cost rel"] = abs(float(outs[0][2]) / float(outs[1][2]) - 1)
    if (max(worst["ilqr actions"], worst["cem action"]) > SMALL_MPC_TOL
            or max(worst["ilqr cost rel"], worst["cem cost rel"]) > 1e-4
            or worst["ilqr moved"] < 0.05):
        raise AssertionError(f"small iLQR / CEM card vs CPU: {worst}")
    return worst


def count_syncs(fn) -> int:
    """Host syncs in one call of fn (torch.cuda.set_sync_debug_mode's
    warnings)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchronizing" in str(w.message) for w in seen)


def ilqr_path(env):
    """(14c) The iLQR control step at bench200: ``MpcController(env,
    method='ilqr')`` (IlqrConfig(horizon=12, iters=8, 5 step sizes) as the
    controller builds it), reset, ILQR_WARMUP warm-up and ILQR_STEPS timed
    control steps (act + env step), launch counts set to 0 just before;
    then act ms (synchronised, host clock), device operations and busy ms
    per act, host syncs per act.  K1-K3 once per env step, K4 and K5
    never; the mean goal distance falls."""
    from img_env_tpu_torch import MpcController, MppiConfig
    from img_env_tpu_torch.ops import kernels

    ctl = MpcController(env, MppiConfig(horizon=H, samples=K),
                        method="ilqr")
    kernels.reset_launch_counts()
    state, _ = env.reset()
    at_reset = dict(kernels.LAUNCHES)
    mss = ctl.init_state()
    goal_d = lambda st: float((st.robots.goal - st.robots.pose[:, :2])
                              .norm(dim=-1).mean())
    d0 = goal_d(state)

    def control_step():
        nonlocal state, mss
        actions, mss, costs = ctl.act(state, mss)
        state, obs, *_ = env.step(state, actions)
        return costs

    for _ in range(ILQR_WARMUP):
        control_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ILQR_STEPS):
        costs = control_step()
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / ILQR_STEPS * 1e3
    launches = dict(kernels.LAUNCHES)
    steps = ILQR_WARMUP + ILQR_STEPS
    per_step = {k: (v - at_reset[k]) / steps for k, v in launches.items()}
    d1 = goal_d(state)
    act_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctl.act(state, mss)
        torch.cuda.synchronize()
        act_ms.append((time.perf_counter() - t0) * 1e3)
    ops, busy = device_profile(lambda: ctl.act(state, mss))
    syncs = count_syncs(lambda: ctl.act(state, mss))
    out = dict(ms_step=ms_step, act_ms=float(np.mean(act_ms)), ops=ops,
               busy_ms=busy, idle_share=1.0 - busy / float(np.mean(act_ms)),
               syncs=syncs, per_step=per_step, launches=launches,
               goal_d=(d0, d1), costs_finite=bool(torch.isfinite(costs).all()),
               arrived=int(state.robots.arrive.sum()),
               codes=torch.bincount(state.robots.collision.long(),
                                    minlength=4).tolist())
    bad = [k for k in ("raster", "fill", "paint") if per_step[k] != 1.0]
    bad += [k for k in ("pedmap", "paint_block") if per_step[k]]
    if bad or not out["costs_finite"] or not d1 < d0:
        raise AssertionError(f"iLQR bench200: launches per step {per_step}, "
                             f"goal distance {d0} -> {d1}, finite costs "
                             f"{out['costs_finite']}")
    return out


def barn_path(device="cuda"):
    """(14d) BARN with the goal field: worlds 0-99 generated in a temporary
    directory (``generate_worlds(n=100, seed0=0)``), then
    ``run_barn_suite_batched`` with run_barn's profile (MppiConfig(horizon=8,
    samples=64, goal_field=True) and its corridor weights), 3 episodes a
    world, max_steps 150, one chunk of 100, the launch counts set to 0 just
    before and read just after (each partial redraw's observation launches
    K1-K3 once more; the env steps and redraws are counted).  Then, from a
    fresh reset of the same 100 worlds and 3 steps: device operations and
    busy ms of the goal fields alone, of the act and of the env step; the
    fields card vs CPU bit for bit; K1-K3 against their twins at these
    shapes.  Fails unless the arrive share over the 300 episodes is at
    least BARN_ARRIVE_FLOOR and the static-collision share at most
    BARN_STATIC_COLL_CEIL."""
    import tempfile

    from img_env_tpu_torch import BatchedNavEnv, EnvConfig, MpcController
    from img_env_tpu_torch.datasets import barn
    from img_env_tpu_torch.eval import barn as eval_barn
    from img_env_tpu_torch.mpc.cost import geodesic_field
    from img_env_tpu_torch.ops import kernels
    from img_env_tpu_torch.parallel import batched_env

    mc, w8 = eval_barn.corridor_profile()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        worlds = barn.generate_worlds(tmp, n=BARN_WORLDS, seed0=0)
        out["generate_s"] = time.perf_counter() - t0
        cfg = EnvConfig.from_dict(barn.world_cfg_dict(worlds[0]))
        counts = {"steps": 0, "redraws": 0, "redrawn": 0}
        cls = batched_env.BatchedNavEnv
        real_step, real_reset = cls.step, cls.reset

        def step(self, *args, **kw):
            counts["steps"] += 1
            return real_step(self, *args, **kw)

        def reset(self, samples=None, carry=None, static_maps=None):
            if carry is not None:
                counts["redraws"] += 1
                counts["redrawn"] += int(samples)
            return real_reset(self, samples, carry, static_maps)

        cls.step, cls.reset = step, reset
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            rows = eval_barn.run_barn_suite_batched(
                worlds, cfg, mpc=mc, mpc_weights=w8,
                episodes_per_world=BARN_EPISODES, max_steps=BARN_MAX_STEPS,
                chunk=BARN_WORLDS, device=device)
            torch.cuda.synchronize()
            out["wall_s"] = time.perf_counter() - t0
        finally:
            cls.step, cls.reset = real_step, real_reset
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = dict(kernels.LAUNCHES)
        steps = counts["steps"]
        # the first reset and each redraw observe once: leave them out
        per_step = {k: (v - (1 + counts["redraws"]) * (k in (
            "raster", "fill", "paint"))) / steps for k, v in launches.items()}
        episodes = sum(r["episodes"] for r in rows)
        out.update(
            counts=counts, steps=steps, launches=launches,
            per_step=per_step, episodes=episodes,
            ms_step=out["wall_s"] / steps * 1e3,
            arrive=sum(r["arrive_rate"] * r["episodes"] for r in rows)
            / episodes,
            static_coll=sum(r["static_coll_rate"] * r["episodes"]
                            for r in rows) / episodes,
            stuck=sum(r["stuck_rate"] * r["episodes"] for r in rows)
            / episodes,
            worlds_below=sum(r["arrive_rate"] < 1.0 for r in rows))
        if episodes != BARN_WORLDS * BARN_EPISODES:
            raise AssertionError(f"BARN: {episodes} episodes")
        bad = [k for k in ("raster", "fill", "paint") if per_step[k] != 1.0]
        bad += [k for k in ("paint_block",) if per_step[k]]
        if bad:
            raise AssertionError(f"BARN: launches per step {per_step}, "
                                 f"{counts}")

        # profiled steps from a fresh reset of the same worlds
        benv = BatchedNavEnv(cfg, device)
        ctl = MpcController(benv.core, mc, weights=w8)
        maps_t = torch.as_tensor(eval_barn.load_padded_maps(worlds, cfg),
                                 device=benv.device)
        states, obs = benv.reset(BARN_WORLDS, static_maps=maps_t)
        mss = ctl.init_scenes_state(BARN_WORLDS)
        for _ in range(3):
            actions, mss, _ = ctl.act_scenes(states, mss)
            states, obs, *_ = benv.step(states, actions)
        wc = ctl.world_cost(states)
        goals = states.robots.goal.reshape(-1, 2)
        field = lambda dev: geodesic_field(
            wc.edt[wc.scene].to(dev), float(wc.resolution), goals.to(dev),
            wc.robot_radius)
        f_g, f_c = field(device), field("cpu")
        mism = int((f_g.cpu().view(torch.int32)
                    != f_c.view(torch.int32)).sum())
        out["field_mismatch"] = mism
        out["field_shape"] = tuple(f_g.shape)
        out["field_reached"] = float((f_c < f_c.max()).float().mean())
        if mism:
            raise AssertionError(f"BARN: geodesic fields card != CPU "
                                 f"({mism} cells)")
        out["field_ops"], out["field_busy_ms"] = device_profile(
            lambda: field(device))
        out["act_ops"], out["act_busy_ms"] = device_profile(
            lambda: ctl.act_scenes(states, mss))
        out["env_ops"], out["env_busy_ms"] = device_profile(
            lambda: benv.step(states, actions))
        out["idle_share"] = 1.0 - (out["act_busy_ms"] + out["env_busy_ms"]) \
            / out["ms_step"]
        out["act_syncs"] = count_syncs(lambda: ctl.act_scenes(states, mss))
        out["kernel_ms"] = selfcheck_eval(benv, states, "barn100")
        out["shapes"] = dict(maps=tuple(states.obs_map.shape),
                             view=benv.core.statics.polar.params.hpx,
                             beams=benv.core.cfg.range_total)
    if (out["arrive"] < BARN_ARRIVE_FLOOR
            or out["static_coll"] > BARN_STATIC_COLL_CEIL):
        raise AssertionError(f"BARN: arrive share {out['arrive']:.4f} "
                             f"(floor {BARN_ARRIVE_FLOOR}), static-collision "
                             f"share {out['static_coll']:.4f} (ceiling "
                             f"{BARN_STATIC_COLL_CEIL})")
    return out


# ---- phase 15: the mesh on the card ----

# __graft_entry__._production_cfg's program (the JAX package's
# production-shape dryrun): 8 robots a scene with offset sensors on the
# odd ones (two sensor groups), 10 circle obstacles and 4 SFM leg peds in
# room_10, 400x400 views at 0.015 m, 960 beams; 8 scenes over 2 ranks.
# The sensor offsets go under "robot", where the config reads them
# (config.py:92); the JAX dict puts them at the top level, where they are
# not read, so its dryrun runs one sensor group
PRODUCTION = {
    "env_name": "dryrun_big",
    "control_hz": 0.4,
    "robot": {"total": 8, "shape": ["circle"], "size": [[0.0, 0.0, 0.17]],
              "begin_poses_type": ["range"],
              "begin_poses": [[1.0, 9.0, 1.0, 9.0]],
              "target_poses_type": ["range"],
              "target_poses": [[1.0, 9.0, 1.0, 9.0]],
              "sensor_cfgs": [[0.0, 0.0] if i % 2 == 0 else [0.1, 0.0]
                              for i in range(8)]},
    "object": {"total": 10, "shape": ["circle"],
               "size_range": [[0.15, 0.25]], "poses_type": ["range"],
               "poses": [[1.5, 8.5, 1.5, 8.5]]},
    "ped_sim": {"total": 4, "type": "pedscene", "max_speed": [0.5],
                "shape": ["leg"], "size": [[0.0, 0.1, 0.1]],
                "begin_poses_type": ["range"],
                "begin_poses": [[1.0, 9.0, 1.0, 9.0]],
                "target_poses_type": ["range"],
                "target_poses": [[1.0, 9.0, 1.0, 9.0]], "go_back": "yes"},
    "global_map": {"map_file": "room_10.png", "resolution": 0.1},
    "view_map": {"resolution": 0.015, "width": 6.0, "height": 6.0},
    "range_total": 960,
    "max_ped": 4,
    "state_dim": 3,
}
MESH_RANKS = 2
MESH_SCENES = 8
MESH_STEPS = 3
# the fields tests/test_multidev_parity.py:36-43 holds bit-exact across
# sharding, and the vector fields it holds to 1e-12
MESH_BITEXACT = ("sensor_maps", "lasers", "angular_maps", "is_collisions",
                 "is_arrives")
MESH_VECTORS = ("vector_states", "ped_vector_states", "ped_maps", "step_ds")
# a rank's collectives time out after this many seconds (a dead peer ends
# the phase), and the phase kills its ranks after RANK_TIMEOUT_S
RANK_PG_TIMEOUT_S = 120.0
RANK_TIMEOUT_S = 400.0


def stage5_update(mesh):
    """Phase 13's stage-5 continuation (TRAIN_ARGS: 32 scenes, unroll 16,
    2 x 2 minibatches, warm-started, pi_log_std -2) over ``mesh`` (None:
    no mesh), set up as train/run.py sets it up: a rollout of the initial
    parameters gives one minibatch's gradient (``minibatch_grads`` of
    GRAD_SAMPLES global samples), then one update.  Returns the gradient,
    the minibatch's loss terms, the update's loss, parameters and seconds,
    and what the comparison with one process needs."""
    import dataclasses

    from img_env_tpu_torch import BatchedNavEnv
    from img_env_tpu_torch.models.policy import PolicyConfig, init_policy
    from img_env_tpu_torch.train import ppo, run

    args = run.parse_args(TRAIN_ARGS)
    cfg = run.load_config(args.cfg)
    dev = torch.device("cuda")
    env = BatchedNavEnv(cfg, dev, seed=args.seed + 1, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model, params = init_policy(gen, dataclasses.replace(
        PolicyConfig.from_env_config(cfg), log_std_init=args.sigma0), dev)
    params = run.restore_params(args.restore, params)
    params["pi_log_std"] = torch.full_like(params["pi_log_std"],
                                           args.force_sigma)
    pcfg = ppo.PpoConfig(unroll=args.unroll, lr=args.lr, epochs=args.epochs,
                         minibatches=args.minibatches,
                         ent_coef=args.ent_coef,
                         reward_scale=args.reward_scale)
    init_fn, step = ppo.make_train_step(env, model, pcfg)
    states, obs = env.reset(args.scenes)
    gen.manual_seed(args.seed + 2)
    _, obs_r, traj = step.rollout(params, states, obs, gen, None)
    last = step.forward(params, ppo.obs_features(obs_r, True))[-1]
    data, _ = ppo.rollout_data(traj, last, pcfg)
    n_all = args.unroll * args.scenes * cfg.robot.total
    idx = torch.randperm(n_all, generator=gen, device=dev)[:GRAD_SAMPLES]
    grads, terms = step.minibatch_grads(params, data, idx)
    tim = {}
    ts, _, _, m = step(init_fn(params), states, obs, gen, timings=tim)
    return dict(grads=grads, terms=terms, loss=m["loss"], params=ts.params,
                update_s=sum(tim.values()), timings=tim, model=model,
                params0=params, pcfg=pcfg, data=data, idx=idx, env=env,
                unroll=args.unroll, scenes=args.scenes)


def mesh_of_one_path():
    """15a: the stage-5 continuation over ``make_mesh()`` (a world of one
    rank, NCCL for CUDA tensors) against the same without a mesh, from the same seeds, with
    cuDNN's deterministic algorithms: the minibatch gradient, the loss
    terms, the update's loss and parameters must be bit-equal.  Returns
    (the largest differences, the update seconds of both)."""
    import torch.distributed as dist

    from img_env_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    if ((mesh.size(0), mesh.size(1), dist.get_world_size()) != (1, 1, 1)
            or "cuda:nccl" not in dist.get_backend_config()):
        raise AssertionError(f"mesh of one: {mesh}, world "
                             f"{dist.get_world_size()} "
                             f"{dist.get_backend_config()}")
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        a, b = stage5_update(mesh), stage5_update(None)
    finally:
        torch.backends.cudnn.deterministic = saved
    diff = lambda x, y: float((x.double() - y.double()).abs().max())
    out = {"grads": max(diff(a["grads"][k], v)
                        for k, v in b["grads"].items()),
           "terms": diff(a["terms"], b["terms"]),
           "loss": diff(a["loss"], b["loss"]),
           "params": max(diff(a["params"][k], v)
                         for k, v in b["params"].items())}
    if any(out.values()):
        raise AssertionError(f"mesh of one: not bit-equal to no mesh {out}")
    return out, (a["update_s"], b["update_s"])


def mesh_batch_rank() -> dict:
    """15b, one rank: PRODUCTION's MESH_SCENES scenes sharded over the
    ranks (gloo, CUDA tensors), reset with the env's own draws and
    MESH_STEPS steps, launch counts set to 0 before the steps and read
    after; then the unsharded batch from the same seed on this rank's
    rows.  Returns the field errors, launches, ms per step and the
    sharded env's set-up seconds (statics from the cache the parent
    warmed)."""
    from img_env_tpu_torch import BatchedNavEnv, EnvConfig
    from img_env_tpu_torch.ops import kernels
    from img_env_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    cfg = EnvConfig.from_dict(PRODUCTION)
    t0 = time.perf_counter()
    env = BatchedNavEnv(cfg, "cuda", seed=0, mesh=mesh)
    env_s = time.perf_counter() - t0
    blk = env.block(MESH_SCENES)
    n = cfg.robot.total
    # robot 0 of each scene beeps, so the beep draws matter
    actions = torch.tensor([[0.4, 0.3, 1.0]] + [[0.5, -0.2, 0.0]] * (n - 1),
                           device="cuda").expand(MESH_SCENES, n, 3)
    states, obs = env.reset(MESH_SCENES)
    seq, ms = [obs], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for _ in range(MESH_STEPS):
        t0 = time.perf_counter()
        states, obs, _, _, _ = env.step(states, actions[blk])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        seq.append(obs)
    launches = dict(kernels.LAUNCHES)
    whole = BatchedNavEnv(cfg, "cuda", seed=0)
    st_w, obs_w = whole.reset(MESH_SCENES)
    errors = []
    for t in range(MESH_STEPS + 1):
        if t:
            st_w, obs_w, _, _, _ = whole.step(st_w, actions)
        e = {f: int((getattr(seq[t], f) != getattr(obs_w, f)[blk]).sum())
             for f in MESH_BITEXACT}
        e.update({f: float((getattr(seq[t], f).double()
                            - getattr(obs_w, f)[blk].double()).abs().max())
                  for f in MESH_VECTORS})
        errors.append(e)
    return {"block": [blk.start, blk.stop], "launches": launches, "ms": ms,
            "errors": errors, "env_s": env_s,
            "card": torch.cuda.get_device_name(0)}


def _gather_samples(x, unroll: int, rows: slice, b_all: int, group):
    """The global [T*B, ...] samples from this rank's [T*B_loc, ...]
    (time-major; its robots are the global ``rows``): each rank's rows
    written into zeros, summed over the ranks (exact)."""
    import torch.distributed as dist

    loc = x.reshape((unroll, -1) + tuple(x.shape[1:]))
    full = loc.new_zeros((unroll, b_all) + tuple(x.shape[1:]))
    full[:, rows] = loc
    dist.all_reduce(full, group=group)
    return full.reshape((unroll * b_all,) + tuple(x.shape[1:]))


def mesh_update_rank() -> dict:
    """15c, one rank: the stage-5 continuation sharded over the ranks (16
    of its 32 scenes), one update.  Returns the loss's bits, whether the
    loss and the updated parameters equal rank 0's bit for bit, the
    worst ratio of the minibatch gradient (summed over the ranks) to the
    error model around the one-process gradient of the same global
    samples (gathered from the ranks), its leaf, and the seconds."""
    import torch.distributed as dist

    from img_env_tpu_torch.parallel.mesh import make_mesh
    from img_env_tpu_torch.train import ppo

    mesh = make_mesh()
    group = mesh.get_group("scene")
    r = stage5_update(mesh)
    first = r["loss"].reshape(1).clone()
    dist.broadcast(first, src=0, group=group)
    flat = torch.cat([v.reshape(-1) for v in r["params"].values()])
    flat0 = flat.clone()
    dist.broadcast(flat0, src=0, group=group)
    env, unroll = r["env"], r["unroll"]
    n = env.cfg.robot.total
    b_all = r["scenes"] * n
    blk = env.block(r["scenes"])
    rows = slice(blk.start * n, blk.stop * n)
    feats, *rest = r["data"]
    gather = lambda x: (None if x is None else
                        _gather_samples(x, unroll, rows, b_all, group))
    data = (tuple(gather(f) for f in feats), *(gather(x) for x in rest))
    mb = ppo.take(data, r["idx"])
    _, _, want = ppo.loss_and_grads(r["model"], r["params0"], mb, r["pcfg"])
    sums = ppo.grad_term_sums(r["model"], r["params0"], mb, r["pcfg"])
    ratios = ppo.grad_error_ratios(r["grads"], want, sums)
    return {"loss": float(r["loss"]), "loss_hex": float(r["loss"]).hex(),
            "loss_equal": bool(torch.equal(first, r["loss"].reshape(1))),
            "params_equal": bool(torch.equal(flat, flat0)),
            "grad_ratio": max(ratios.values()),
            "grad_leaf": max(ratios, key=ratios.get),
            "update_s": r["update_s"], "timings": r["timings"],
            "block": [blk.start, blk.stop], "scenes": r["scenes"]}


def run_ranks(fn: str, env=None):
    """``chip_smoke.<fn>`` in MESH_RANKS spawned ranks (gloo: two ranks on
    one card); raises with a failed rank's errors."""
    from img_env_tpu_torch.parallel.distributed import spawn

    runs = spawn(f"chip_smoke:{fn}", MESH_RANKS, backend="gloo",
                 timeout_s=RANK_TIMEOUT_S, pg_timeout_s=RANK_PG_TIMEOUT_S,
                 env=env)
    for k, r in enumerate(runs):
        if r.rc or r.result is None:
            raise AssertionError(f"{fn}: rank {k} rc {r.rc}\n"
                                 f"{r.out[-3000:]}\n{r.err[-6000:]}")
    return [r.result for r in runs]


def mesh_path():
    """Phase 15: 15a (mesh of one), the statics' cold and warm seconds with
    the cache on, 15b (the production batch sharded over two ranks), 15c
    (a sharded PPO update over two ranks).  Returns what it measured."""
    import shutil
    import tempfile

    from img_env_tpu_torch import EnvConfig, NavEnv
    from img_env_tpu_torch.utils import statics_cache

    t15 = time.perf_counter()
    out = {}
    out["one"], out["one_s"] = mesh_of_one_path()
    torch.cuda.empty_cache()
    cache = tempfile.mkdtemp(prefix="statics_cache_")
    saved = os.environ.get(statics_cache.ENV_VAR)
    os.environ[statics_cache.ENV_VAR] = cache
    try:
        out["statics_s"] = {}
        for name, cfg_dict in (("bench200", BENCH200),
                               ("production", PRODUCTION)):
            secs = out["statics_s"][name] = []
            for _ in range(2):
                t0 = time.perf_counter()
                NavEnv(EnvConfig.from_dict(cfg_dict))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        out["cache_files"] = sorted(os.listdir(cache))
        torch.cuda.empty_cache()
        out["batch"] = run_ranks("mesh_batch_rank",
                                 {statics_cache.ENV_VAR: cache})
    finally:
        if saved is None:
            os.environ.pop(statics_cache.ENV_VAR, None)
        else:
            os.environ[statics_cache.ENV_VAR] = saved
        shutil.rmtree(cache, ignore_errors=True)
    once = {"raster": 1, "fill": 2, "paint": 2, "pedmap": 1,
            "paint_block": 0}
    for k, r in enumerate(out["batch"]):
        if r["block"] != [k * MESH_SCENES // MESH_RANKS,
                          (k + 1) * MESH_SCENES // MESH_RANKS]:
            raise AssertionError(f"mesh batch: rank {k} holds {r['block']}")
        for t, e in enumerate(r["errors"]):
            bad = {f: v for f, v in e.items()
                   if (v > 0 if f in MESH_BITEXACT else v > 1e-12)}
            if bad:
                raise AssertionError(f"mesh batch: rank {k} step {t} "
                                     f"differs from the unsharded batch "
                                     f"{bad}")
        if any(r["launches"][name] != c * MESH_STEPS
               for name, c in once.items()):
            raise AssertionError(f"mesh batch: rank {k} launched "
                                 f"{r['launches']} in {MESH_STEPS} steps")
    out["update"] = run_ranks("mesh_update_rank")
    for k, r in enumerate(out["update"]):
        if not (r["loss_equal"] and r["params_equal"]
                and math.isfinite(r["loss"])):
            raise AssertionError(f"mesh update: rank {k} {r}")
        if not r["grad_ratio"] <= 1.0:
            raise AssertionError(f"mesh update: rank {k} gradient at "
                                 f"{r['grad_ratio']} of the error model "
                                 f"({r['grad_leaf']})")
    out["seconds"] = time.perf_counter() - t15
    return out


def report_mesh(ms) -> None:
    """Logs what ``mesh_path`` measured."""
    from img_env_tpu_torch.train import ppo

    card = card_line()
    log(f"# mesh of one (NCCL, world 1), stage-5 continuation at 32 scenes: "
        f"the minibatch gradient, loss terms, update loss and parameters "
        f"bit-equal to the update without a mesh (largest differences "
        f"{json.dumps(ms['one'])}); update {ms['one_s'][0]:.3f} s with the "
        f"mesh, {ms['one_s'][1]:.3f} s without; {card}")
    log(f"# statics with IMG_ENV_TPU_STATICS_CACHE, NavEnv set-up cold / "
        f"warm: " + ", ".join(f"{k} {v[0]:.3f} / {v[1]:.3f} s"
                               for k, v in ms["statics_s"].items())
        + f" (production: {MESH_SCENES // MESH_RANKS} of {MESH_SCENES} "
        f"scenes a rank, 400x400 views, 960 beams, two sensor groups; "
        f"entries {ms['cache_files']}); {card}")
    for k, r in enumerate(ms["batch"]):
        log(f"# mesh batch rank {k} of {MESH_RANKS} (gloo, scenes "
            f"{r['block']}): sharded = unsharded bit for bit on "
            f"{', '.join(MESH_BITEXACT)} and the vector fields within 1e-12 "
            f"over reset + {MESH_STEPS} steps; ms per step "
            f"{[round(x, 3) for x in r['ms']]} (host clock, synchronised); "
            f"launches in {MESH_STEPS} steps {r['launches']}; env set-up "
            f"{r['env_s']:.3f} s (warm cache); {card}")
    for k, r in enumerate(ms["update"]):
        log(f"# mesh update rank {k} of {MESH_RANKS} (gloo, scenes "
            f"{r['block']} of {r['scenes']}): loss {r['loss']!r} ({r['loss_hex']}), "
            f"equal to rank 0's: {r['loss_equal']}; parameters equal to rank "
            f"0's: {r['params_equal']}; the all-reduced minibatch gradient "
            f"({GRAD_SAMPLES} samples) at {r['grad_ratio']:.4f} of the "
            f"error model around the one-process gradient (worst leaf "
            f"{r['grad_leaf']}; {ppo.GRAD_REL} of the largest term sum + "
            f"{ppo.GRAD_ABS}); update {r['update_s']:.3f} s "
            f"({json.dumps({x: round(v, 3) for x, v in r['timings'].items()})}"
            f"); {card}")
    log(f"# phase 15: {ms['seconds']:.1f} s")


# ---- phase 16: the papers' experiment matrix at full width, the hardware
# and external-simulator frontends, the remaining drivers ----

MATRIX_STEPS = 20           # 16a's `reduced`: control steps of each cell
ORCA_STEPS = 5              # timed control steps of one ORCA cell
FRONTEND_STEPS = 30         # 16b: stage-5 policy steps on each frontend


class StepProbe:
    """Instruments the evaluator of ``experiment_matrix.run_cell`` without
    touching it: the checkpoint's policy_fn is wrapped in a
    ``CountingPolicy`` (ms per control step, the launch counts at the
    reset) and ``BatchedNavEnv.step`` sums the robots' beep flags on the
    card (read once, at the end) and keeps the last env, states and
    observation."""

    def __init__(self):
        self.policy = None
        self.env = self.states = self.obs = None
        self.beeps = None

    def __enter__(self):
        from img_env_tpu_torch.models import policy as pol_mod
        from img_env_tpu_torch.parallel.batched_env import BatchedNavEnv

        self._load, self._step = pol_mod.load_ckpt_policy, BatchedNavEnv.step
        probe = self

        def load(*a, **k):
            fn, policy = probe._load(*a, **k)
            probe.policy = CountingPolicy(fn)
            return probe.policy, policy

        def step(env, states, actions, beep_u=None):
            out = probe._step(env, states, actions, beep_u)
            n = out[0].robots.beep.sum()
            probe.beeps = n if probe.beeps is None else probe.beeps + n
            probe.env, probe.states, probe.obs = env, out[0], out[1]
            return out

        pol_mod.load_ckpt_policy, BatchedNavEnv.step = load, step
        return self

    def __exit__(self, *exc):
        from img_env_tpu_torch.models import policy as pol_mod
        from img_env_tpu_torch.parallel.batched_env import BatchedNavEnv

        pol_mod.load_ckpt_policy, BatchedNavEnv.step = self._load, self._step


def probed_cell(cfg_dict, ckpt, bank, steps, **kw):
    """``run_cell`` of a checkpoint over the bank's 50 scenes for ``steps``
    control steps, under a ``StepProbe``; returns (cell output, probe,
    launches per control step, ms per control step)."""
    from img_env_tpu_torch.eval import experiment_matrix as em
    from img_env_tpu_torch.ops import kernels

    with StepProbe() as probe:
        kernels.reset_launch_counts()
        out = em.run_cell(cfg_dict, "ckpt", bank, EVAL_EPISODES, ckpt=ckpt,
                          max_steps=steps, **kw)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    fn = probe.policy
    per_step = {k: (v - fn.at_first[k]) / fn.calls
                for k, v in kernels.LAUNCHES.items()}
    return out, probe, per_step, (t_end - fn.t_first) / fn.calls * 1e3


def check_render(probe, cfg) -> int:
    """render_frame, render_tiles and compose_gui of a beeping scene of the
    card's last state equal the same functions of that state moved to the
    CPU; returns the scene drawn."""
    from img_env_tpu_torch.core.state import map_tree
    from img_env_tpu_torch.eval.live_view import compose_gui
    from img_env_tpu_torch.eval.render import render_frame, render_tiles

    statics = probe.env.core.statics
    beeping = probe.states.robots.beep.any(-1).nonzero().flatten()
    k = int(beeping[0]) if beeping.numel() else 0
    card = map_tree(lambda x: x[k], probe.states)
    host = map_tree(lambda x: x.cpu(), card)
    maps = probe.obs.sensor_maps[k]
    for name, got, want in (
            ("render_frame", render_frame(card, statics,
                                          beep_radius=cfg.beep_r),
             render_frame(host, statics, beep_radius=cfg.beep_r)),
            ("render_tiles", render_tiles(maps), render_tiles(maps.cpu())),
            ("compose_gui", compose_gui(card, statics, maps, cfg),
             compose_gui(host, statics, maps.cpu(), cfg))):
        if not np.array_equal(got, want):
            raise AssertionError(f"16a: {name} of the card's state != the "
                                 f"CPU's")
    return k


def matrix_path() -> dict:
    """16a: one ORCA cell's control step timed (part B's rvoscene cell of
    the stage-5 policy), then part C's two cells (the ERVO checkpoint on
    ervoscene over bank50's 50 scenes, beep on and forced off) through
    ``experiment_matrix.run_cell`` for MATRIX_STEPS control steps: K1-K4
    once a step, the beeps, the indicator table without matplotlib, the
    renderers card = CPU, ms per control step and the idle share."""
    import shutil
    import tempfile

    from img_env_tpu_torch import EnvConfig, ScenarioBank, mean_action_fn
    from img_env_tpu_torch.config import read_config
    from img_env_tpu_torch.eval import experiment_matrix as em
    from img_env_tpu_torch.eval import plots

    bank = ScenarioBank.load(BANK50)
    ervo = read_config(em.ERVO_CFG)
    res = {}
    (s_orca, _), _, per_orca, ms_orca = probed_cell(
        em.crowd_variant(ervo, "rvoscene", 2), em.STAGE5, bank, ORCA_STEPS)
    res["orca"] = dict(ms_step=ms_orca, per_step=per_orca, summary=s_orca)
    recs = {}
    for beep, off in (("on", False), ("off", True)):
        (summary, dones, rec), probe, per_step, ms = probed_cell(
            ervo, em.ERVO, bank, MATRIX_STEPS, force_beep_off=off,
            record=True)
        beeps = int(probe.beeps)
        if dones.shape != (EVAL_EPISODES, 1):
            raise AssertionError(f"16a: dones_info shape {dones.shape}")
        for k in ("raster", "fill", "paint", "pedmap"):
            if per_step[k] != 1.0:
                raise AssertionError(f"16a beep {beep}: {k} launched "
                                     f"{per_step[k]} times a step")
        if per_step["paint_block"]:
            raise AssertionError("16a: K5 launched")
        if (beeps == 0) if beep == "on" else (beeps != 0):
            raise AssertionError(f"16a beep {beep}: {beeps} robot beeps")
        if len(rec.episodes) != EVAL_EPISODES or len(
                rec.episodes[0].robot_poses) != probe.policy.calls:
            raise AssertionError("16a: the recorder's episodes")
        recs[f"beep {beep}"] = rec
        res[beep] = dict(summary=summary, per_step=per_step, ms_step=ms,
                         beeps=beeps, steps=probe.policy.calls,
                         policy_share=probe.policy.seconds
                         / (ms * probe.policy.calls / 1e3))
        if beep == "on":
            cfg = EnvConfig.from_dict(ervo)
            res["render_scene"] = check_render(probe, cfg)
            policy_fn = mean_action_fn(load_ervo("cuda"), cfg)
            benv, states, obs = probe.env, probe.states, probe.obs

            def control_step():
                nonlocal states, obs
                a = policy_fn(None, obs)
                states, obs, *_ = benv.step(states, a)
                for x in (obs.is_collisions, obs.is_arrives,
                          obs.ped_min_dists):
                    x.cpu()

            res["ops"], res["busy_ms"] = device_profile(control_step)
            res["idle_share"] = 1.0 - res["busy_ms"] / ms
    out_dir = tempfile.mkdtemp(prefix="matrix16a_")
    try:
        rows = {name: plots.per_robot_indicators(r)["all"]
                for name, r in recs.items()}
        table = plots.compare_methods(recs, out_dir, figures=False)
        if table != rows or os.listdir(out_dir) != ["comparison.csv"]:
            raise AssertionError("16a: the comparison table")
        with open(os.path.join(out_dir, "comparison.csv")) as f:
            res["table_csv"] = f.read().strip().replace("\n", " | ")
    finally:
        shutil.rmtree(out_dir)
    if "matplotlib" in sys.modules:
        raise AssertionError("16a: the table imported matplotlib")
    return res


def load_ervo(device):
    from img_env_tpu_torch import EnvConfig, load_policy_npz
    from img_env_tpu_torch.config import read_config
    from img_env_tpu_torch.eval import experiment_matrix as em

    return load_policy_npz(em.ERVO, EnvConfig.from_dict(
        read_config(em.ERVO_CFG)), device)


class CircleSim:
    """A numpy unicycle among circle obstacles with two tracked peds: the
    external simulator of 16b.  Scans (``n_beams`` over the full circle)
    are cast on the host against CIRCLES; LOW is a kerb below the scan
    plane that only the bumper feels.  A command moves the robot one
    control period; a robot disc of ROBOT_R that then overlaps a circle or
    the kerb counts a contact, and a teleport clears the count.
    ``clearance`` (the least gap to a scanned circle's edge) and
    ``on_kerb`` keep the last move's ground truth."""

    CIRCLES = np.asarray([[2.0, -0.7, 0.3], [2.6, 1.1, 0.25],
                          [3.6, 0.2, 0.35], [1.2, 1.6, 0.2],
                          [4.4, 2.2, 0.3], [0.8, -1.5, 0.4]])
    LOW = np.asarray([[0.0, -1.0, 0.15]])
    ROBOT_R = 0.17

    def __init__(self, n_beams: int, dt: float):
        from img_env_tpu_torch.env.hardware_env import ScanSample, TrackedPed

        self.scan_cls, self.ped_cls = ScanSample, TrackedPed
        self.n_beams, self.dt = n_beams, dt
        self.pose = np.zeros(3)
        self.t = 0
        self.contacts = 0
        self.clearance, self.on_kerb = math.inf, False

    def set_model_state(self, x, y, yaw):
        self.pose = np.asarray([x, y, yaw], np.float64)
        self.contacts = 0

    def get_model_state(self):
        return tuple(self.pose)

    def send_cmd(self, v, w):
        x, y, th = self.pose
        self.pose = np.asarray([x + v * math.cos(th) * self.dt,
                                y + v * math.sin(th) * self.dt,
                                th + w * self.dt])

        def gap(c):
            return np.hypot(*(c[:, :2] - self.pose[:2]).T) - c[:, 2]

        self.clearance = float(gap(self.CIRCLES).min())
        self.on_kerb = bool((gap(self.LOW) < self.ROBOT_R).any())
        if self.clearance < self.ROBOT_R or self.on_kerb:
            self.contacts += 1
        self.t += 1

    def get_contact(self):
        c = self.contacts > 0
        self.contacts = 0
        return c

    def get_scan(self):
        ang = -math.pi + 2 * math.pi * np.arange(self.n_beams) / self.n_beams
        wa = ang + self.pose[2]
        dirs = np.stack([np.cos(wa), np.sin(wa)], -1)          # [R, 2]
        rel = self.CIRCLES[:, :2] - self.pose[:2]              # [C, 2]
        b = dirs @ rel.T                                       # [R, C]
        c = (rel ** 2).sum(-1) - self.CIRCLES[:, 2] ** 2
        disc = b ** 2 - c
        hit = b - np.sqrt(np.maximum(disc, 0.0))
        hit = np.where((disc >= 0) & (hit > 0), hit, np.inf)
        return self.scan_cls(ranges=hit.min(-1), angle_min=-math.pi,
                             angle_increment=2 * math.pi / self.n_beams)

    def get_peds(self):
        s = 0.1 * self.t
        return [self.ped_cls((1.5 + s, 0.4), (0.4, 0.0)),
                self.ped_cls((3.0, 2.0 - s), (0.0, -0.4))]

    def feed(self, hw) -> None:
        """Hand the scan, the pose and the tracked peds to a real_env."""
        hw.feed_scan(self.get_scan())
        hw.feed_pose(*self.get_model_state())
        hw.feed_peds(self.get_peds())


# 16b's scripted episodes: (name, the done code they must end with, legs of
# (waypoint, how far short of it to stop)).  'min laser' heads for 0.13 m
# from a scanned circle's edge, inside the laser threshold (robot_radius,
# 0.17 m);
# 'contact' runs onto the kerb, which the scan does not see; 'arrival'
# drives round the circles to within the frontend's goal radius (1 m for
# gazebo_env, 0.3 m for real_env).  The frontends emit 0, 1 and 5 only,
# in both packages: codes 2 and 3 are the simulator's ped and robot
# contacts.
ARRIVAL_LEGS = (((1.5, 0.3), 0.0), ((3.1, 0.65), 0.0), ((3.4, 1.0), 0.0),
                ((4.0, 1.5), 0.0))
SCRIPTS = {
    "gazebo_env": (("min laser", 1, (((2.0, -0.7), 0.43),)),
                   ("contact", 1, (((0.0, -1.0), 0.25),)),
                   ("arrival", 5, ARRIVAL_LEGS)),
    "real_env": (("arrival", 5, ARRIVAL_LEGS),),
}
SCRIPT_MAX_STEPS = 80       # per scripted episode


def drive_cmd(pose, target, stop: float, dt: float):
    """The scripted driver's (v, w): turn in place toward ``target`` until
    the heading is within 0.05 rad, then drive so that the step ends
    ``stop`` m short of it, within the stage-5 action box (v in [0, 0.6],
    w in [-0.9, 0.9])."""
    dx, dy = target[0] - pose[0], target[1] - pose[1]
    err = math.atan2(dy, dx) - pose[2]
    err = math.atan2(math.sin(err), math.cos(err))
    w = max(-0.9, min(0.9, err / dt))
    if abs(err) > 0.05:
        return 0.0, w
    return max(0.0, min(0.6, (math.hypot(dx, dy) - stop) / dt)), w


def frontend_pair(kind: str, raw: dict):
    """The stage-5 config with ``env_type`` switched, its wrapper stack over
    a frontend on the card and one on the CPU, each fed by its own
    CircleSim: ((card env, card sim), (CPU env, CPU sim)).  The frontends'
    vector state is the goal in the base frame and the relative yaw
    (``state_goal``), 3 wide in both packages (F28), so ``state_dim`` is
    3."""
    from img_env_tpu_torch import make_env
    from img_env_tpu_torch.env.external_env import ExternalSimTransport

    d = dict(raw, env_type=kind, state_dim=3,
             start_global_pose=[0.0, 0.0, 0.0],
             target_global_pose=[4.0, 1.5])
    pairs = []
    for device in ("cuda", "cpu"):
        sim = CircleSim(int(raw["range_total"]), float(raw["control_hz"]))
        if kind == "gazebo_env":
            env = make_env(d, device=device, transport=ExternalSimTransport(
                get_scan=sim.get_scan, get_model_state=sim.get_model_state,
                set_model_state=sim.set_model_state, send_cmd=sim.send_cmd,
                get_contact=sim.get_contact, get_peds=sim.get_peds))
            env.env.real_time = False
        else:
            box = {}

            def send(v, w, sim=sim, box=box):
                sim.send_cmd(v, w)
                sim.feed(box["hw"])

            env = make_env(d, device=device, send_cmd=send)
            box["hw"] = env.env
            env.env.set_goal(4.0, 1.5)
            sim.feed(env.env)
        pairs.append((env, sim))
    return pairs


def _same(a, b) -> bool:
    """Equal nested dicts / sequences / tensors / arrays (NaN = NaN)."""
    if a is None or b is None:
        return a is b
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        a, b = a.cpu().numpy(), b.cpu().numpy()
    a, b = np.asarray(a), np.asarray(b)
    return np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def step_pair(what: str, env_g, env_c, action: np.ndarray) -> int:
    """One step of the card's and the CPU's frontend on the same action:
    the step's outputs and then the observations (raw and filtered) must
    be equal.  Returns the step's done code."""
    out_g, out_c = env_g.step(action), env_c.step(action)
    if not _same(out_g[1:], out_c[1:]):
        raise AssertionError(f"16b {what}: step outputs differ")
    if not (_same(out_g[0], out_c[0])
            and _same(env_g.last_raw_obs, env_c.last_raw_obs)):
        raise AssertionError(f"16b {what}: observations differ")
    return int(out_g[3]["dones_info"][0])


def scripted_episodes(kind: str, pairs) -> list:
    """16b's SCRIPTS on one frontend pair: each episode from the start pose
    (a reset; real_env's robot is put back there first), driven by
    ``drive_cmd`` on the card sim's pose with the card and the CPU held
    equal at every step, must end with its code and agree with the sim's
    ground truth: 'min laser' inside the laser threshold of a scanned
    circle and off the kerb, 'contact' on the kerb and clear of the
    threshold.  Returns one dict per episode."""
    (env_g, sim_g), (env_c, sim_c) = pairs
    res = []
    for name, want, legs in SCRIPTS[kind]:
        if kind == "real_env":
            for env, sim in pairs:
                sim.set_model_state(0.0, 0.0, 0.0)
                sim.feed(env.env)
        if not _same(env_g.reset(), env_c.reset()):
            raise AssertionError(f"16b {kind} {name}: resets differ")
        leg, codes = 0, []
        while len(codes) < SCRIPT_MAX_STEPS:
            target, stop = legs[leg]
            if leg + 1 < len(legs) and math.hypot(
                    target[0] - sim_g.pose[0],
                    target[1] - sim_g.pose[1]) - stop < 1e-3:
                leg += 1
                continue
            v, w = drive_cmd(sim_g.pose, target, stop, sim_g.dt)
            codes.append(step_pair(f"{kind} {name} step {len(codes)}",
                                   env_g, env_c, np.float32([[v, w]])))
            if codes[-1]:
                break
        if codes[-1] != want or any(codes[:-1]):
            raise AssertionError(f"16b {kind} {name}: codes {codes}, want "
                                 f"{want} at the end and 0 before")
        # the last move's truth (a reset's teleport leaves it)
        clear, kerb = sim_g.clearance, sim_g.on_kerb
        if name == "min laser" and not (clear < sim_g.ROBOT_R and not kerb):
            raise AssertionError(f"16b {kind} min laser: {clear} {kerb}")
        if name == "contact" and not (kerb and clear >= sim_g.ROBOT_R):
            raise AssertionError(f"16b {kind} contact: {clear} {kerb}")
        res.append(dict(name=name, code=want, steps=len(codes),
                        clearance=clear, on_kerb=kerb))
    return res


def frontends_path() -> dict:
    """16b: ``make_env`` with 'gazebo_env' over a CircleSim transport and
    with 'real_env' fed scans, poses and tracked peds, both under the
    stage-5 config's wrapper stack, on the card; every observation (the
    raw one on the device, the log-polar sensor map included) equal to the
    same frontend's on the CPU fed the same commands.  First the stage-5
    policy drives FRONTEND_STEPS steps, its actions within POLICY_TOL of
    the CPU's.  Its 5-wide vector state is the frontend's 3 and the last
    command's (v, w), as the simulator's state_dim 5 carries them; given
    that vector and a log-polar map it was not trained on, it turns in
    place.  Then ``scripted_episodes`` drive the robot into each done code
    the frontend computes: min laser (1), contact (1) and arrival (5) on
    gazebo_env, arrival (5) on real_env."""
    import copy

    from img_env_tpu_torch import mean_action_fn

    policy, cfg = load_stage5("cuda")
    with open(POLICY_ENV, encoding="utf-8") as f:
        raw = json.load(f)
    fns = (mean_action_fn(policy, cfg),
           mean_action_fn(copy.deepcopy(policy).cpu(), cfg))

    def act(k, env, last):
        obs = env.last_raw_obs
        vec = torch.cat([obs.vector_states,
                         last.to(obs.vector_states.device)[None]], -1)
        return fns[k](None, obs._replace(vector_states=vec))

    res = {}
    for kind in ("gazebo_env", "real_env"):
        pairs = frontend_pair(kind, raw)
        (env_g, _), (env_c, _) = pairs
        if env_g.device.type != "cuda" or env_g.env.device.type != "cuda":
            raise AssertionError(f"16b {kind}: the frontend is not on the "
                                 f"card")
        if not _same(env_g.reset(), env_c.reset()):
            raise AssertionError(f"16b {kind}: resets differ")
        last = torch.zeros(2)
        worst, codes, t0 = 0.0, [], time.perf_counter()
        for t in range(FRONTEND_STEPS):
            a_g, a_c = act(0, env_g, last), act(1, env_c, last)
            worst = max(worst, float((a_g.cpu() - a_c).abs().max()))
            if not torch.allclose(a_g.cpu(), a_c, rtol=POLICY_TOL,
                                  atol=POLICY_TOL):
                raise AssertionError(f"16b {kind}: actions card vs CPU "
                                     f"{worst}")
            last = a_g[0].cpu()
            codes.append(step_pair(f"{kind} policy step {t}", env_g, env_c,
                                   last.numpy()[None]))
        sm = env_g.last_raw_obs.sensor_maps
        if not (sm.is_cuda and bool((sm == 1.0).any())):
            raise AssertionError(f"16b {kind}: no hit in the sensor map")
        policy_s = time.perf_counter() - t0
        policy_metrics = env_g.metrics.summary()
        t0 = time.perf_counter()
        scripted = scripted_episodes(kind, pairs)
        res[kind] = dict(worst=worst, codes=codes, s=policy_s,
                         metrics=policy_metrics, scripted=scripted,
                         scripted_s=time.perf_counter() - t0,
                         scripted_metrics=env_g.metrics.summary())
    return res


def drivers_path() -> dict:
    """16c: ``eval.evaluate --batch --policy ckpt`` over 4 bank episodes
    and ``examples.run_mpc --render`` at a few steps on the card; the PNG
    read back by the port's map loader."""
    import contextlib
    import io
    import shutil
    import tempfile

    from img_env_tpu_torch.env.maps import decode_png
    from img_env_tpu_torch.eval import evaluate
    from img_env_tpu_torch.examples import run_mpc

    out = tempfile.mkdtemp(prefix="drivers16c_")
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            evaluate.main(["--batch", "--policy", "ckpt", "--episodes", "4",
                           "--max-steps", "3", "--bank", BANK50])
        text = buf.getvalue()
        if "arrive_rate" not in text:
            raise AssertionError(f"16c evaluate: {text}")
        png = os.path.join(out, "mpc.png")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run_mpc.main(["--steps", "3", "--render", png])
        img = decode_png(png)
        if img.ndim != 3 or img.shape[2] != 3 or img.max() == img.min():
            raise AssertionError(f"16c run_mpc: PNG {img.shape}")
        return dict(evaluate=" ".join(text.split()),
                    run_mpc=buf.getvalue().strip().splitlines()[-2],
                    png=list(img.shape))
    finally:
        shutil.rmtree(out)


def report_phase16(mx, fe, dr, seconds) -> None:
    o = mx["orca"]
    log(f"# ORCA cell (part B, rvoscene, stage-5 policy, 50 scenes): "
        f"{o['ms_step']:.3f} ms per control step over {ORCA_STEPS} steps; "
        f"launches per step {o['per_step']}")
    for beep in ("on", "off"):
        c = mx[beep]
        log(f"# matrix 16a, part C beep {beep} (ERVO policy, ervoscene, 50 "
            f"scenes; reduced: {c['steps']} of 101 control steps): "
            f"{c['ms_step']:.3f} ms per control step, policy share "
            f"{c['policy_share']:.4f}, robot beeps {c['beeps']}, launches "
            f"per step {c['per_step']}, summary {json.dumps(c['summary'])}")
    log(f"# matrix 16a: {mx['ops']:.1f} device operations and "
        f"{mx['busy_ms']:.4f} ms device busy per control step, idle share "
        f"{mx['idle_share']:.4f}; renderers card = CPU (scene "
        f"{mx['render_scene']}); table without matplotlib: "
        f"{mx['table_csv']}")
    for kind, r in fe.items():
        log(f"# frontend 16b {kind}: {FRONTEND_STEPS} stage-5 policy steps "
            f"on the card in {r['s']:.3f} s, observations = CPU, actions "
            f"card vs CPU max error {r['worst']:.3g} (tolerance "
            f"{POLICY_TOL}); dones_info {r['codes']}; metrics "
            f"{json.dumps(r['metrics'])}")
        eps = "; ".join(
            f"{e['name']} -> code {e['code']} after {e['steps']} steps "
            f"(clearance {e['clearance']:.4f} m, on kerb {e['on_kerb']})"
            for e in r["scripted"])
        log(f"# frontend 16b {kind}: scripted episodes on the card in "
            f"{r['scripted_s']:.3f} s, observations and outputs = CPU: "
            f"{eps}; metrics {json.dumps(r['scripted_metrics'])}")
    log(f"# drivers 16c: evaluate --batch --policy ckpt: {dr['evaluate']}; "
        f"run_mpc --render: {dr['run_mpc']}, PNG {dr['png']}")
    log(f"# phase 16: {seconds:.1f} s")


def phase16():
    """Phase 16 with float32 without TF32, as in phases 1-12 and 14."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mx = matrix_path()
    fe = frontends_path()
    dr = drivers_path()
    report_phase16(mx, fe, dr, time.perf_counter() - t0)
    return mx


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(1)
    # torch's own TF32 flags, restored for the training path (phase 13)
    tf32_defaults = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"# torch {torch.__version__} cuda {torch.version.cuda}")
    log(card_line())

    from img_env_tpu_torch import EnvConfig, MpcController, MppiConfig, NavEnv
    from img_env_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.library()
    log(f"# kernels built in {time.perf_counter() - t0:.3f} s")

    def make(cfg_dict):
        t0 = time.perf_counter()
        env = NavEnv(EnvConfig.from_dict(cfg_dict))
        ctl = MpcController(env, MppiConfig(horizon=H, samples=K))
        t_statics = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, _ = env.reset()
        torch.cuda.synchronize()
        log(f"# {cfg_dict['env_name']}: host statics + tables "
            f"{t_statics:.3f} s, reset {time.perf_counter() - t0:.3f} s "
            f"(P'={env.statics.polar.n_slots}, gated "
            f"{env.statics.polar.n_fill_slots}, "
            f"K3 visits {env.tables.painter.slots[1].numel()})")
        return env, ctl, state

    env, ctl, state = make(BENCH200)
    env_p, ctl_p, state_p = make(BENCH200PED)
    env_e, ctl_e, state_e = make(BENCH200ERVO)
    checks = selfcheck(env, state, [("bench200ped", env_p, state_p),
                                    ("bench200ervo", env_e, state_e)])
    checks["pedmap"] = selfcheck_pedmap(env_p, state_p)
    for name, c in checks.items():
        if name != "paint_subsets":
            log(f"# {name}: {c[1]:.4f} ms, bound {c[3] * 1e3:.2f} us "
                f"({c[4]}: {c[5]} bytes, {c[6]} operations), share "
                f"{c[3] / c[1]:.3f}, plain {c[2]:.4f} ms")

    # ---- the bench200 path ----
    run = run_path(env, ctl, WARMUP, BENCH_ITERS, ("raster", "fill", "paint"),
                   never=("paint_block", "pedmap"))
    launches, state = run.launches, run.state
    n = env.cfg.robot.total
    check_shapes(run.obs, {"sensor_maps": (n, 48, 48), "lasers": (n, 960),
                           "vector_states": (n, 3), "angular_maps": (n, 72)})
    log(f"# bench200 control step: {run.ms_step:.3f} ms/step over "
        f"{BENCH_ITERS} steps (+{WARMUP} warm-up), checksum "
        f"{run.checksum:.6f}, arrived {int(state.robots.arrive.sum())}/{n}, "
        f"collided {int((state.robots.collision > 0).sum())}/{n}, "
        f"launches {launches}")

    def crowd_path(name, env_c, ctl_c, iters, beep=False):
        """A crowd path (K1-K4 on every step, never K5); logs and checks
        its outcome.  Returns its PathRun and peak memory (GiB)."""
        torch.cuda.reset_peak_memory_stats()
        run = run_path(env_c, ctl_c, WARMUP, iters,
                       ("raster", "fill", "paint", "pedmap"),
                       never=("paint_block",), crowd=True, beep=beep)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check_shapes(run.obs, {"sensor_maps": (n, 48, 48),
                               "lasers": (n, 960),
                               "ped_vector_states": (n, 71),
                               "ped_maps": (n, 3, 48, 48)})
        if run.obs.ped_min_dists.shape != (n,):
            raise AssertionError(f"{name} path: bad ped_min_dists")
        st = run.state
        moved = float((st.peds.pos - run.state0.peds.pos).norm(dim=-1)
                      .mean())
        codes = torch.bincount(st.robots.collision.long(), minlength=4)
        steps = WARMUP + iters
        log(f"# {name} control step: {run.ms_step:.3f} ms/step over {iters} "
            f"steps (+{WARMUP} warm-up), checksum {run.checksum:.6f}, peds "
            f"moved {moved:.3f} m on average, ped-map occupancy "
            f"{int(run.obs.ped_maps[:, 0].sum())} px, beeps "
            f"{run.beeps / steps:.1f} per step, arrived "
            f"{int(st.robots.arrive.sum())}/{n}, collision codes 0/1/2/3 "
            f"{codes.tolist()}, launches {run.launches} ({steps} steps + "
            f"reset), peak memory {peak:.3f} GiB, "
            f"{env_c.cfg.ped_sim.total} peds")
        if moved <= 0.0:
            raise AssertionError(f"{name} path: the peds did not move")
        if beep and run.beeps == 0:
            raise AssertionError(f"{name} path: no robot beeped")
        return run, peak

    # ---- the crowd path (bench200ped) ----
    run_p, _ = crowd_path("crowd", env_p, ctl_p, ITERS)

    # ---- the ERVO path (bench200ervo), then the 'orca' head ----
    run_e, _ = crowd_path("ERVO", env_e, ctl_e, ERVO_ITERS, beep=True)
    ops, busy, host = orca_step_cost(env_e, run_e.state)
    log(f"# ORCA crowd step at bench200ervo: {ops} device operations, "
        f"device busy {busy:.3f} ms, host {host:.3f} ms per step"
        + ("" if ops else " (profiler saw no device events: not measured)"))
    ctl_o = MpcController(env_e, MppiConfig(horizon=H, samples=K),
                          ped_prediction="orca")
    torch.cuda.reset_peak_memory_stats()
    run_o = run_path(env_e, ctl_o, 1, 2, ("raster", "fill", "paint",
                                          "pedmap"),
                     never=("paint_block",), crowd=True, beep=True)
    log(f"# 'orca' head: {run_o.ms_step:.3f} ms/step over 2 steps (+1 "
        f"warm-up) vs the 'cv' head's {run_e.ms_step:.3f}, checksum "
        f"{run_o.checksum:.6f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")

    # ---- the block-painter path ----
    launches_b, per_step_b = block_path(BENCH200, env)
    log(f"# block-painter path: launches {launches_b} "
        f"(reset + {BLOCK_STEPS} steps)")

    for name, cfg_dict, ds in (
            ("small", SMALL, None), ("small crowd", SMALL_PED, None),
            ("test.yaml (rvoscene)", SMALL_RVO, None),
            ("ervo_crowd.yaml (ervoscene)", SMALL_ERVO, None),
            ("small dataset", SMALL_DATASET,
             synthetic_dataset(4, 24, SMALL_DATASET["control_hz"]))):
        worst = small_reference(cfg_dict, "cuda", ds)
        log(f"# {name} config card vs CPU: worst {worst}")

    # ---- scene batches, fast mode, sensor groups ----
    from img_env_tpu_torch import BatchedNavEnv

    def make_batch(cfg_dict):
        t0 = time.perf_counter()
        benv = BatchedNavEnv(EnvConfig.from_dict(cfg_dict))
        ctl_b = MpcController(benv.core, MppiConfig(horizon=H, samples=K))
        t_statics = time.perf_counter() - t0
        t0 = time.perf_counter()
        states, _ = benv.reset()
        torch.cuda.synchronize()
        log(f"# {cfg_dict['env_name']}: host statics + tables "
            f"{t_statics:.3f} s, reset of {states.obs_map.shape[0]} scenes "
            f"{time.perf_counter() - t0:.3f} s")
        return benv, ctl_b, states

    batches = {"4x50": make_batch(MULTI_4X50),
               "16x12": make_batch(MULTI_16X12)}
    env_f, ctl_f, state_f = make(FAST200)
    env_fp, ctl_fp, state_fp = make(FAST200PED)
    env_g, ctl_g, state_g = make(GROUPS200)
    batch_ms = selfcheck_batches(
        {k: (b[0], b[2]) for k, b in batches.items()}, (env_g, state_g),
        (env_f, state_f), (env_p, state_p))
    log(f"# kernel times at these shapes (ms): {batch_ms}")

    batch_runs = {}
    for name, (benv, ctl_b, _) in batches.items():
        run_b, ops_b, busy_b = run_batch_path(
            benv, ctl_b, WARMUP, BATCH_ITERS,
            {"raster": 1, "fill": 1, "paint": 1},
            never=("paint_block", "pedmap"))
        s_, n_ = run_b.state.robots.pose.shape[:2]
        check_shapes(run_b.obs, {"sensor_maps": (s_, n_, 48, 48),
                                 "lasers": (s_, n_, 960),
                                 "vector_states": (s_, n_, 3)})
        rate = s_ * n_ * K / (run_b.ms_step / 1e3)
        log(f"# multi-scene {name}: {run_b.ms_step:.3f} ms/step over "
            f"{BATCH_ITERS} steps (+{WARMUP} warm-up), {rate:.0f} aggregate "
            f"rollouts/s, device busy {busy_b:.4f} ms and {ops_b:.1f} device "
            f"operations per step, checksum {run_b.checksum:.6f}, arrived "
            f"{int(run_b.state.robots.arrive.sum())}/{s_ * n_}, launches "
            f"per step {run_b.per_step}")
        batch_runs["multi " + name] = run_b

    def one_step(env_x, ctl_x, state_x):
        ms0 = ctl_x.init_state()

        def step():
            actions, _, _ = ctl_x.act(state_x, ms0)
            env_x.step(state_x, actions)
        return step

    for name, env_x, ctl_x, crowd in (
            ("fast bench200", env_f, ctl_f, False),
            ("fast bench200ped", env_fp, ctl_fp, True)):
        must = ("raster", "fill", "paint") + (("pedmap",) if crowd else ())
        run_x = run_path(env_x, ctl_x, WARMUP, BATCH_ITERS, must,
                         never=("paint_block",) + (() if crowd
                                                  else ("pedmap",)),
                         crowd=crowd)
        ops_x, busy_x = device_profile(one_step(env_x, ctl_x, run_x.state))
        check_shapes(run_x.obs, {"sensor_maps": (n, 48, 48),
                                 "lasers": (n, 960)})
        log(f"# {name} control step: {run_x.ms_step:.3f} ms/step over "
            f"{BATCH_ITERS} steps (+{WARMUP} warm-up), device busy "
            f"{busy_x:.4f} ms and {ops_x:.1f} device operations per step, "
            f"checksum {run_x.checksum:.6f}, view "
            f"{env_x.statics.polar.params.hpx} px at "
            f"{env_x.statics.polar.params.resolution} m, launches per step "
            f"{run_x.per_step}")
        batch_runs[name] = run_x

    run_g = run_path(env_g, ctl_g, 1, GROUP_STEPS - 1,
                     ("raster", "fill", "paint"),
                     never=("paint_block", "pedmap"))
    if run_g.per_step["fill"] != 2 or run_g.per_step["paint"] != 2:
        raise AssertionError(f"groups path: K2 / K3 per step "
                             f"{run_g.per_step}, not once per group")
    check_shapes(run_g.obs, {"sensor_maps": (n, 48, 48), "lasers": (n, 960)})
    ops_g, busy_g = device_profile(one_step(env_g, ctl_g, run_g.state))
    log(f"# bench200 with 2 sensor groups: reset + {GROUP_STEPS} steps, "
        f"{run_g.ms_step:.3f} ms/step over {GROUP_STEPS - 1}, device busy "
        f"{busy_g:.4f} ms and {ops_g:.1f} device operations per step, "
        f"checksum {run_g.checksum:.6f}, launches per step {run_g.per_step}")
    batch_runs["bench200 groups"] = run_g

    for name, (cfg_dict, scenes) in SMALL_BATCHES.items():
        worst = small_batch_reference(cfg_dict, scenes, "cuda")
        log(f"# small {name} batch ({scenes} scenes) card vs CPU: worst "
            f"{worst}")

    # ---- the evaluation path: the stage-5 policy over bank50 ----
    policy, eval_cfg = load_stage5("cuda")
    ev = eval_path(policy, eval_cfg)
    summ = ev["summary"]
    err, card_ms, cpu_ms = ev["policy_check"]
    log(f"# eval bank50 summary: {json.dumps(summ)}")
    log(f"# eval bank50: {ev['wall_s']:.3f} s wall for the reset and "
        f"{ev['steps']} control steps, {ev['ms_step']:.3f} ms per control "
        f"step, policy share {ev['policy_share']:.4f}; {ev['ops']:.1f} "
        f"device operations and {ev['busy_ms']:.4f} ms device busy per step, "
        f"idle share {ev['idle_share']:.4f}; the crowd alone (50 SFM scene "
        f"steps) {ev['crowd_ops']:.1f} operations, {ev['crowd_busy_ms']:.4f} "
        f"ms busy, {ev['crowd_host_ms']:.3f} ms host per step; the policy "
        f"forward {ev['policy_ops']:.1f} operations, "
        f"{ev['policy_busy_ms']:.4f} ms device busy, {card_ms:.4f} ms a call "
        f"on the card ({cpu_ms:.3f} ms on the CPU), card vs CPU max error "
        f"{err:.3g} (tolerance {POLICY_TOL}); launches per step "
        f"{ev['per_step']}, at the reset {ev['at_reset']}; kernel ms at "
        f"these shapes {ev['kernel_ms']}")
    if summ["arrive_rate"] < ARRIVE_FLOOR:
        raise AssertionError(f"eval bank50: arrive rate "
                             f"{summ['arrive_rate']} < {ARRIVE_FLOOR}")
    steps_small, summ_small = small_eval_reference("cuda")
    log(f"# small evaluator config card vs CPU: facade episode of "
        f"{steps_small} steps and a 3-episode evaluation equal; "
        f"{json.dumps(summ_small)}")
    for name, ms in ev["kernel_ms"].items():
        batch_ms[name]["eval bank50"] = ms

    # ---- the training path: PPO on the stage-5 policy, and from scratch,
    # under torch's default TF32 flags ----
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
        tf32_defaults)
    log(f"# train: TF32 flags restored to torch's defaults (cuDNN "
        f"{tf32_defaults[0]}, matmul {tf32_defaults[1]})")
    worst, moved, n_reset = small_train_reference("cuda")
    log(f"# small crowd train step card vs CPU: done, collision and arrival "
        f"codes equal, {n_reset} scene reset on both, parameters within "
        f"{worst:.3g} (tolerance {STEP_TOL}; they moved {moved:.3g})")
    tr = train_path()
    report_train(tr)
    curves, easy_wall = easy_train_path()
    per_run = [(round(float(c[:10].mean()), 3),
                round(float(c[-10:].mean()), 3)) for c in curves]
    log(f"# easy train from scratch (16 scenes, unroll 16, 50 updates, "
        f"seeds {EASY_SEEDS}): {easy_wall:.3f} s; reward_mean first-10 mean "
        f"{curves[:, :10].mean():.4f} -> last-10 mean "
        f"{curves[:, -10:].mean():.4f} over the runs; (first-10, last-10) "
        f"per run {per_run}; mean curve "
        f"{[round(float(x), 3) for x in curves.mean(0)]}")
    for name, ms in tr["kernel_ms"].items():
        batch_ms[name]["train stage5"] = ms

    # ---- the rest of the MPC engine and the BARN benchmark (phase 14),
    # float32 without TF32 as in phases 1-12 ----
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t14 = time.perf_counter()
    lqt = lqt_check()
    log(f"# LQT, {LQT_ROBOTS} robots x H=12 (n=3, m=2): {json.dumps(lqt)} "
        f"(float64 within 1e-8; float32 worst relative to each output's "
        f"largest entry, tolerance {LQT_TOL_F32})")
    small = small_mpc_reference()
    log(f"# small iLQR act and CEM card vs CPU: {json.dumps(small)} "
        f"(actions within {SMALL_MPC_TOL}, costs within rtol 1e-4)")
    il = ilqr_path(env)
    log(f"# iLQR bench200 (200 robots, H=12, 8 iterations, 5 step sizes): "
        f"{il['ms_step']:.3f} ms per control step over {ILQR_STEPS} steps "
        f"(+{ILQR_WARMUP} warm-up), act {il['act_ms']:.3f} ms (host clock, "
        f"synchronised), {il['ops']:.1f} device operations and "
        f"{il['busy_ms']:.4f} ms device busy per act, idle share of the act "
        f"{il['idle_share']:.4f}, {il['syncs']} host syncs per act; mean "
        f"goal distance {il['goal_d'][0]:.4f} -> {il['goal_d'][1]:.4f} m, "
        f"arrived {il['arrived']}/200, collision codes 0/1/2/3 "
        f"{il['codes']} (iLQR's cost has no collision term; the JAX "
        f"controller collides alike: tools/ilqr_collisions.py); "
        f"launches per step {il['per_step']}")
    br = barn_path()
    log(f"# BARN, worlds 0-{BARN_WORLDS - 1} x {BARN_EPISODES} episodes "
        f"(max_steps {BARN_MAX_STEPS}, goal-field MPPI H=8 K=64): arrive "
        f"share {br['arrive']:.4f} over {br['episodes']} episodes, static "
        f"collision {br['static_coll']:.4f}, stuck {br['stuck']:.4f}, "
        f"{br['worlds_below']} worlds below 1.0; {br['wall_s']:.3f} s wall, "
        f"{br['steps']} control steps, {br['ms_step']:.3f} ms per control "
        f"step (redraws {br['counts']['redraws']} of "
        f"{br['counts']['redrawn']} worlds); per step {br['field_ops']:.1f} "
        f"device operations in the goal fields ({br['field_busy_ms']:.4f} "
        f"ms busy), {br['act_ops'] - br['field_ops']:.1f} in the rest of "
        f"the act ({br['act_busy_ms'] - br['field_busy_ms']:.4f} ms), "
        f"{br['env_ops']:.1f} in the env step ({br['env_busy_ms']:.4f} ms); "
        f"idle share {br['idle_share']:.4f}; {br['act_syncs']} host syncs "
        f"per act; peak memory {br['peak_gib']:.3f} GiB; fields "
        f"{br['field_shape']} card = CPU ({br['field_mismatch']} mismatched "
        f"cells, {br['field_reached']:.3f} of cells reached); shapes "
        f"{br['shapes']}; worlds generated in {br['generate_s']:.3f} s; "
        f"launches per step {br['per_step']}; kernel ms {br['kernel_ms']}")
    log(f"# phase 14: {time.perf_counter() - t14:.1f} s")
    for name, ms in br["kernel_ms"].items():
        batch_ms[name]["barn100"] = ms

    # ---- the mesh (phase 15): a mesh of one, the production batch and a
    # PPO update sharded over two ranks on the one card ----
    mesh_run = mesh_path()
    report_mesh(mesh_run)

    # ---- the matrix, the frontends and the drivers (phase 16) ----
    mx = phase16()

    src = "img_env_tpu_torch/csrc/"
    meta = {"raster": ("raster.cu", "img_env_tpu/ops/pallas_raster.py:105",
                       launches),
            "fill": ("fill.cu", "img_env_tpu/ops/pallas_fill.py:228",
                     launches),
            "paint": ("paint.cu", "img_env_tpu/ops/pallas_paint_t.py:215",
                      launches),
            "pedmap": ("pedmap.cu", "img_env_tpu/ops/pallas_pedmap.py:116",
                       run_p.launches),
            "paint_block": ("paint_block.cu",
                            "img_env_tpu/ops/pallas_paint.py:152",
                            launches_b)}
    per_step = {"bench200": run.per_step, "bench200ped": run_p.per_step,
                "bench200ervo": run_e.per_step,
                "bench200 paint_mode=block": per_step_b,
                **{k: r.per_step for k, r in batch_runs.items()},
                "eval bank50": ev["per_step"],
                "train stage5": tr["per_step"],
                "ilqr bench200": il["per_step"], "barn100": br["per_step"],
                **{f"production 2 ranks, rank {k}": {
                    name: c / MESH_STEPS for name, c in r["launches"].items()}
                   for k, r in enumerate(mesh_run["batch"])},
                "matrix ORCA cell": mx["orca"]["per_step"],
                "matrix part C beep on": mx["on"]["per_step"],
                "matrix part C beep off": mx["off"]["per_step"]}
    rows = [{"name": name, "route": "cuda", "source": src + cu,
             "replaces": replaces, "launches": runs[name],
             "launches_per_step": {p: c[name] for p, c in per_step.items()},
             "max_abs_err": checks[name][0], "ms": checks[name][1],
             "plain_ms": checks[name][2], "bound_ms": checks[name][3],
             "bound_by": checks[name][4], "bytes": checks[name][5],
             "ops": checks[name][6], "library_ms": None,
             "batch_ms": batch_ms[name],
             **({"subset_ms": checks["paint_subsets"]} if name == "paint"
                else {})}
            for name, (cu, replaces, runs) in meta.items()]
    import torch.distributed as dist

    if dist.is_initialized():    # the world of one of phases 13 and 15
        dist.destroy_process_group()
    log(card_line())
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
