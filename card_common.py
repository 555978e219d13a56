"""Configurations and helpers of the card tests (``tests/test_torch_card_*.py``
and the production-shape cases of ``tests/test_torch_cuda_kernels.py``), of
their ranks (``card_batch_rank``, ``card_update_rank``: gloo ranks holding
CUDA tensors, started by ``parallel.distributed.spawn``) and of the
measurement scripts that run the same inputs (``tools/kernel_times.py``,
``tools/train_curves.py``, ``tools/grad_terms.py``).  A module of the
repository's root, so that the ranks and the scripts import it by its
name.  Imports only the port and torch; nothing here needs a card until a
function is called.
"""

from __future__ import annotations

import subprocess

import torch
import torch.distributed as dist

# bench.py:31-56: 200 robots, 200 obstacles, 16 m room at 0.1 m, 400x400
# views at 0.015 m, 960-beam lasers (MPPI K=128 H=12 plans it)
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

# bench.py:362-389: the same 200 robots with no obstacles among 200 SFM
# leg peds
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

# bench200ped with the ERVO crowd: ORCA peds that step away from beeping
# robots (beep_r and ped_ca_p of img_env_tpu/configs/ervo_crowd.yaml)
BENCH200ERVO = dict(BENCH200PED, env_name="bench200ervo",
                    ped_sim=dict(BENCH200PED["ped_sim"], type="ervoscene"),
                    beep_r=1.0, ped_ca_p=0.8)

# scene batches, fast mode and sensor groups: bench.py's multi-scene line
# (bench200 with 50 robots a scene, 4 scenes),
# benchmarks/multiscene_profile.py:21's 16 x 12 shape, bench.py's fast
# lines, and tests/test_hetero_sensors.py:24's sensor offsets (even robots
# on the first, odd on the second)
MULTI_4X50 = dict(BENCH200, env_name="multi4x50", num_scenes=4,
                  robot=dict(BENCH200["robot"], total=50))
MULTI_16X12 = dict(BENCH200, env_name="multi16x12", num_scenes=16,
                   robot=dict(BENCH200["robot"], total=12))
FAST200 = dict(BENCH200, env_name="bench200fast", sensor_mode="fast")
FAST200PED = dict(BENCH200PED, env_name="bench200pedfast",
                  sensor_mode="fast")
GROUPS200 = dict(BENCH200, env_name="bench200groups", robot=dict(
    BENCH200["robot"], sensor_cfgs=[[0.15, 0.0], [-0.1, 0.08]] * 100))

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

K = 128             # MPPI samples and horizon of the bench lines
H = 12

# the stage-5 curriculum policy and the env config it was trained with
# (img_env_tpu/configs/baseline_10obs_5ped.yaml, exported by
# tools/export_policy_npz.py), over the 50-episode bank of the README's
# result, every episode a scene of one robot
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
# crowd step, card vs CPU, from one state: (m, m/s) per crowd model
PED_TOL = {
    "pedscene": (1e-4, 5e-3),    # SFM: exp/atan2 ulps; the first step from
                                 # rest is ill-conditioned (ROADMAP F15)
    "rvoscene": (0.0, 0.0),      # ORCA: sqrt, divisions and comparisons,
    "ervoscene": (0.0, 0.0),     # each rounded alike on both devices
    "dataset": (0.0, 0.0),       # replay: a gather
}

# the training path: the stage-5 polish stage of
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
# the full-width gradient, card vs CPU, on minibatches of GRAD_SAMPLES:
# each leaf within the error model of img_env_tpu_torch.train.ppo
# (GRAD_REL of the leaf's largest sum of per-sample term magnitudes, plus
# GRAD_ABS); TF32 convolutions err by >= 3 times the tolerance
GRAD_SAMPLES = 256
# one small train step card vs CPU (clip + sgd 0.05): parameters within
# STEP_TOL (they move by ~5e-3)
STEP_TOL = 1e-5

# __graft_entry__._production_cfg's program (the JAX package's
# production-shape dryrun): 8 robots a scene with offset sensors on the odd
# ones (two sensor groups), 10 circle obstacles and 4 SFM leg peds in
# room_10, 400x400 views at 0.015 m, 960 beams; 8 scenes over 2 ranks.
# The sensor offsets go under "robot", where the config reads them
# (config.py:92)
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

# the fields ``tests/test_multidev_parity.py`` holds bit-exact across
# sharding, and the vector fields it holds to 1e-12
BITEXACT = ("sensor_maps", "lasers", "angular_maps", "is_collisions",
            "is_arrives")
VECTORS = ("vector_states", "ped_vector_states", "ped_maps", "step_ds")


def field_errors(got, want) -> dict:
    """Per observation field: mismatching entries (bit-exact fields) or
    the largest absolute difference (vector fields)."""
    out = {}
    for f in BITEXACT:
        out[f] = int((getattr(got, f) != getattr(want, f)).sum())
    for f in VECTORS:
        g, w = getattr(got, f), getattr(want, f)
        out[f] = float((g.double() - w.double()).abs().max()) if g.numel() \
            else 0.0
    return out


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def to_device(sample, device):
    """A ScenarioSample (or any NamedTuple of tensors) on ``device``."""
    return type(sample)(*(v.to(device) for v in sample))


# ---- sensor-kernel inputs at production shape ----

def crowded_poses(poses):
    """The poses with every odd robot pushed onto its even neighbour
    (forced overlaps: count 2, id sums)."""
    crowded = poses.clone()
    crowded[1::2, :2] = crowded[0::2, :2] + 0.1
    return crowded


def fill_args(env, packed, poses, nps=None):
    """K2's arguments, with the pose terms as ``polar.fill_sorted`` makes
    them (glibc's sin/cos bits, ops/f32.py)."""
    from img_env_tpu_torch.ops import f32

    ps, t = env.statics.polar, env.tables.polar
    sin, cos = f32.sin_cos(poses[:, 2])
    return (packed, cos, sin,
            poses[:, 0].contiguous(), poses[:, 1].contiguous(), t.pix_x,
            t.pix_y, int(ps.n_fill_slots), env.statics.resolution, nps)


def thresholds(env, occ):
    """K3's and K5's inputs (s_hit, s_tail) from the raycast of ``occ``."""
    from img_env_tpu_torch.ops import painter, polar

    _, _, aux = polar.raycast_batched(env.statics.polar, env.tables.polar,
                                      occ)
    return painter.hit_steps(env.statics.painter, env.tables.painter, *aux)


def block_tables(env):
    """K5's tables (the gen-1 64-slot blocks) for ``env``'s painter."""
    from img_env_tpu_torch.ops import painter

    pst = env.statics.painter
    blocks = painter.PaintBlocks.build(pst,
                                       env.statics.view_params.range_total)
    return painter.make_painter_tables(pst, blocks, env.device)


def bench200_packed(env, state, poses):
    """bench200's packed map with the robots at ``poses`` (no peds)."""
    from img_env_tpu_torch.ops import raster

    dev = poses.device
    e, eb = (torch.zeros((0, 1, 2), device=dev),
             torch.zeros((0, 1), dtype=torch.bool, device=dev))
    return raster.build_layers(
        state.obs_map, env.statics.resolution, poses, env.tables.robot_points,
        env.tables.robot_mask, torch.zeros((0, 3), device=dev),
        e, eb, e, eb, e, eb).packed


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
    pos = (torch.arange(visits.numel(), device=off.device)
           - off[:-1].long()[slot])
    beam, T = (visits >> 16).long(), (visits & 0xFFFF).long()
    h, tail = s_hit.long()[:, beam], s_tail.long()[:, beam]
    writes = (T <= h) | (T == h + 1) | (T > tail)
    need = torch.where(writes, pos + 1, counts[slot])
    first = torch.full((s_hit.shape[0], n_slots), 1 << 30,
                       dtype=torch.int64, device=off.device).scatter_reduce(
        1, slot[None].expand_as(need), need, "amin")
    first = torch.where(counts == 0, 0, first)
    return int(first.sum()), int((first > 2).sum())


def pedmap_ties(state):
    """K4's input (px, py, vx, vy) [N, M] at a crowd reset with forced ties:
    every odd ped stacked on its even neighbour, peds on the +-3 m
    window's +x and -y edges, on the robot (range 0) and a ten-way tie;
    each ped with its own seeded velocity (the reset's are all 0), so the
    vx/vy channels name the winning ped.  Also returns that velocity."""
    from img_env_tpu_torch.env import observe

    pos = state.peds.pos
    gen = torch.Generator(device=pos.device)
    gen.manual_seed(0)
    vel = torch.rand(pos.shape, generator=gen, device=pos.device) * 2 - 1
    stacked = pos.clone()
    stacked[1::2] = stacked[0::2]
    px, py, vx, vy = (x.clone() for x in observe.peds_in_base(
        state.robots.pose, stacked, vel))
    px[:, 100:120:2] = 3.0                 # on the window's +x edge
    py[:, 120:140:2] = -3.0                # on its -y edge
    px[:, 140:150] = 0.0                   # on the robot (range 0)
    py[:, 140:150] = 0.0
    px[:, 150:160], py[:, 150:160] = 1.0, 0.5   # a ten-way tie
    return (px, py, vx, vy), vel


# ---- launch counts ----

# kernel launches of one observation: K1 once for every scene, K2 and K3
# once per sensor group (one here), K4 once with peds
SENSORS = {"raster": 1, "fill": 1, "paint": 1}
CROWD = dict(SENSORS, pedmap=1)

def launch_delta(before: dict) -> dict:
    """Kernel launches since ``before`` (a copy of ``kernels.LAUNCHES``)."""
    from img_env_tpu_torch.ops import kernels

    return {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}


class StepLaunches:
    """While active, every ``BatchedNavEnv.step`` must launch each kernel
    exactly ``per_step[name]`` times (the kernels not named: never); counts
    the env steps, the resets and the scenes they reset (every reset, the
    autoreset's and the redraws' too, goes through ``reset_local``).  The
    counters are the host's: no sync.  Also keeps the robots' beeps summed
    on the device over the steps and the last step's (env, states,
    observation)."""

    def __init__(self, per_step: dict):
        self.per_step = per_step
        self.steps = self.resets = self.reset_scenes = 0
        self.beeps = 0
        self.last = None

    def __enter__(self):
        from img_env_tpu_torch.ops import kernels
        from img_env_tpu_torch.parallel.batched_env import BatchedNavEnv

        self.orig = (BatchedNavEnv.step, BatchedNavEnv.reset_local)
        step, reset = self.orig
        want = {k: self.per_step.get(k, 0) for k in kernels.LAUNCHES}

        def counted_step(env, *a, **kw):
            before = dict(kernels.LAUNCHES)
            out = step(env, *a, **kw)
            got = launch_delta(before)
            assert got == want, f"an env step launched {got}, not {want}"
            self.steps += 1
            self.beeps = self.beeps + out[0].robots.beep.sum()
            self.last = (env, out[0], out[1])
            return out

        def counted_reset(env, samples, *a, **kw):
            self.resets += 1
            self.reset_scenes += len(samples)
            return reset(env, samples, *a, **kw)

        BatchedNavEnv.step, BatchedNavEnv.reset_local = (counted_step,
                                                         counted_reset)
        return self

    def __exit__(self, *exc):
        from img_env_tpu_torch.parallel.batched_env import BatchedNavEnv

        BatchedNavEnv.step, BatchedNavEnv.reset_local = self.orig


def kernels_match_twins(benv, states):
    """K1-K4 against their twins at the shapes of a batch of S scenes of
    one robot (the evaluation, training and BARN paths): K1 over the S
    maps, K2 with one robot a scene, K3 on its thresholds, K4 over the S
    robots and their scenes' peds where there are peds."""
    from img_env_tpu_torch.env import observe
    from img_env_tpu_torch.ops import painter, pedmap, polar, raster

    core = benv.core
    t, res = core.tables, core.statics.resolution
    h, w = states.obs_map.shape[-2:]
    pose = states.robots.pose
    cells = raster.world_to_cell(raster.transform_points(pose, t.robot_points),
                                 res)
    assert torch.equal(raster.robot_maps_kernel(cells, t.robot_mask, h, w),
                       raster.robot_maps_twin(cells, t.robot_mask, h, w))
    args = fill_args(core, core._layers(states).packed, pose.reshape(-1, 3),
                     pose.shape[1])
    occ = polar.fill_sorted_kernel(*args)
    assert torch.equal(occ, polar.fill_sorted_twin(*args))
    s_hit, s_tail = thresholds(core, occ)
    pst, pt = core.statics.painter, core.tables.painter
    assert torch.equal(
        painter.paint_slots_kernel(pt, s_hit, s_tail, pst.n_slots),
        painter.paint_sorted(pst, pt, s_hit, s_tail))
    m = states.peds.pos.shape[1]
    if m:
        base = [x.reshape(-1, m) for x in observe.peds_in_base(
            pose, states.peds.pos, states.peds.vel)]
        hs = int(core.cfg.ped_image_size[0])
        r_img = float(core.cfg.ped_image_r)
        assert torch.equal(pedmap.ped_map_kernel(*base, 6.0 / hs, r_img, hs),
                           pedmap.ped_map_twin(*base, 6.0 / hs, r_img, hs))


# ---- the ranks of the mesh tests ----

def stage5_update(mesh) -> dict:
    """The stage-5 continuation (``card_common.TRAIN_ARGS``: 32 scenes,
    unroll 16, 2 x 2 minibatches, warm-started, pi_log_std -2) on the card
    over ``mesh`` (None: no mesh), set up as train/run.py sets it up: a
    rollout of the initial parameters gives one minibatch's gradient
    (``minibatch_grads`` of GRAD_SAMPLES global samples), then one update.
    Returns the gradient, the minibatch's loss terms, the update's loss and
    parameters, and what a comparison with one process needs."""
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
    ts, _, _, m = step(init_fn(params), states, obs, gen)
    return dict(grads=grads, terms=terms, loss=m["loss"], params=ts.params,
                model=model, params0=params, pcfg=pcfg, data=data, idx=idx,
                env=env, unroll=args.unroll, scenes=args.scenes)


def card_batch_rank(scenes: int, steps: int) -> dict:
    """``card_common.PRODUCTION``'s ``scenes`` scenes sharded over the
    ranks on the card, reset with the env's own draws and stepped
    ``steps`` times (robot 0 of each scene beeping, so the beep draws
    matter), the launch counts read over the steps; then the unsharded
    batch of the same seed on this rank's rows.  Returns the field errors
    per step (reset first), the launches and the rank's scenes."""
    from img_env_tpu_torch import BatchedNavEnv, EnvConfig
    from img_env_tpu_torch.ops import kernels
    from img_env_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    cfg = EnvConfig.from_dict(PRODUCTION)
    env = BatchedNavEnv(cfg, "cuda", seed=0, mesh=mesh)
    blk = env.block(scenes)
    n = cfg.robot.total
    actions = torch.tensor([[0.4, 0.3, 1.0]] + [[0.5, -0.2, 0.0]] * (n - 1),
                           device="cuda").expand(scenes, n, 3)
    states, obs = env.reset(scenes)
    seq = [obs]
    kernels.reset_launch_counts()
    for _ in range(steps):
        states, obs, _, _, _ = env.step(states, actions[blk])
        seq.append(obs)
    launches = dict(kernels.LAUNCHES)
    whole = BatchedNavEnv(cfg, "cuda", seed=0)
    st_w, obs_w = whole.reset(scenes)
    rows = lambda tree: type(tree)(*(None if x is None else x[blk]
                                     for x in tree))
    errors = [field_errors(seq[0], rows(obs_w))]
    for t in range(steps):
        st_w, obs_w, _, _, _ = whole.step(st_w, actions)
        errors.append(field_errors(seq[t + 1], rows(obs_w)))
    return {"block": [blk.start, blk.stop], "launches": launches,
            "errors": errors}


def _gather_samples(x, unroll: int, rows: slice, b_all: int, group):
    """The global [T*B, ...] samples from this rank's [T*B_loc, ...]
    (time-major; its robots are the global ``rows``): each rank's rows
    written into zeros, summed over the ranks (exact)."""
    loc = x.reshape((unroll, -1) + tuple(x.shape[1:]))
    full = loc.new_zeros((unroll, b_all) + tuple(x.shape[1:]))
    full[:, rows] = loc
    dist.all_reduce(full, group=group)
    return full.reshape((unroll * b_all,) + tuple(x.shape[1:]))


def card_update_rank() -> dict:
    """The stage-5 continuation sharded over the ranks on the card, one
    update (``stage5_update``).  Returns the loss, whether the loss and the
    updated parameters equal rank 0's bit for bit, and the worst ratio of
    the minibatch gradient (summed over the ranks) to the error model
    around the one-process gradient of the same global samples (gathered
    from the ranks), with its leaf."""
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
    return {"loss": float(r["loss"]),
            "loss_equal": bool(torch.equal(first, r["loss"].reshape(1))),
            "params_equal": bool(torch.equal(flat, flat0)),
            "grad_ratio": max(ratios.values()),
            "grad_leaf": max(ratios, key=ratios.get)}
