"""Numeric conventions shared with the reference simulator.

A copy of ``img_env_tpu.constants``.  Every constant here mirrors a
convention of DRL-Navigation/img_env that both packages preserve for
semantic parity (see SURVEY.md §8).  Citations are `file:line` into the
DRL-Navigation sources.
"""

import numpy as np

# ---------------------------------------------------------------------------
# Grid cell values (uint8 occupancy maps).
# Reference: src/img_env/src/agent.cpp:313-326, 394-401, 503;
#            src/img_env/src/grid_map.cpp:57-60.
# ---------------------------------------------------------------------------
CELL_OBSTACLE = 0        # static obstacle / occupied
CELL_PED = 1             # pedestrian footprint in the world map
CELL_ROBOT = 2           # other-robot footprint in the world map
CELL_SELF_IN_VIEW = 100  # robot's own footprint stamped into its view map
CELL_UNSEEN = 200        # view-map background (outside FOV / shadowed)
CELL_FREE_MIN = 250      # world-map values >= 250 are free space
CELL_VIEW_FREE = 255     # free cell inside the view map

# ---------------------------------------------------------------------------
# Collision codes (returned per robot per step, latched until reset).
# Reference: src/img_env/src/agent.cpp:285-327.
# ---------------------------------------------------------------------------
COLL_NONE = 0
COLL_STATIC = 1
COLL_PED = 2
COLL_ROBOT = 3

# ---------------------------------------------------------------------------
# Episode termination codes ("dones_info").
# Reference: envs/wrapper/base.py:246-247, 289-296.
# ---------------------------------------------------------------------------
DONE_RUNNING = 0
DONE_COLL_STATIC = 1
DONE_COLL_PED = 2
DONE_COLL_ROBOT = 3
DONE_ARRIVE = 5
DONE_TIMEOUT = 10

# ---------------------------------------------------------------------------
# Kinematics.
# Reference: src/img_env/src/agent.cpp:89, 201-218, 213, 277 (arrival radius);
#            agent.cpp:825 (ped waypoint arrive r^2 < 0.04).
# ---------------------------------------------------------------------------
ARRIVE_DIST = 0.3          # robot goal arrival radius [m]
PED_WAYPOINT_DIST_SQ = 0.04  # ped trajectory waypoint advance radius^2 [m^2]
SUBSTEP_DT = 0.05          # arrival-scan substep inside one control step [s]

# ---------------------------------------------------------------------------
# Footprint rasterization.
# Reference: src/img_env/src/agent.cpp:19, 34, 52 (0.01 m point cloud grid).
# ---------------------------------------------------------------------------
FOOTPRINT_RES = 0.01

# The reference builds its view<->base transform with yaw = 3.14159 (not pi),
# src/img_env/src/agent.cpp:86.  We reproduce the same constant so view-space
# coordinates agree to float precision.
VIEW_YAW = 3.14159

# ---------------------------------------------------------------------------
# Laser.
# Reference: src/img_env/src/agent.cpp:407 (72 angular bins), 513 (miss -> 6).
# ---------------------------------------------------------------------------
LASER_MISS_DIST = 6.0
ANGULAR_MAP_SIZE = 72

# ---------------------------------------------------------------------------
# Reward constants (SensorsPaperRewardWrapper).
# Reference: envs/wrapper/base.py:164-187.
# ---------------------------------------------------------------------------
REWARD_COLLISION = -500.0
REWARD_REACH = 500.0
REWARD_STEP = -5.0
REWARD_DISTANCE_FACTOR = 200.0
REWARD_PED_FACTOR = -50.0      # -50 * (ped_safety_space - min_dist)

# ---------------------------------------------------------------------------
# Ped-vector normalization (StatePedVectorWrapper).
# Reference: envs/wrapper/base.py:20-21.
# ---------------------------------------------------------------------------
PED_VEC_AVG = np.array([0.0, 0.0, 0.0, 0.0, 0.25, 0.25, 0.0], np.float32)
PED_VEC_STD = np.array([6.0, 6.0, 0.6, 0.9, 0.50, 0.5, 6.0], np.float32)

# ---------------------------------------------------------------------------
# ORCA agent parameters used by rvoscene/ervoscene for every ped and robot.
# (neighborDist, maxNeighbors, timeHorizon, timeHorizonObst, radius)
# Reference: src/img_env/src/rvoscene.h:57, 63; ervoscene.h:50, 56.
# ---------------------------------------------------------------------------
ORCA_NEIGHBOR_DIST = 0.5
ORCA_MAX_NEIGHBORS = 10
ORCA_TIME_HORIZON = 5.0
ORCA_TIME_HORIZON_OBST = 5.0
ORCA_RADIUS = 0.5
ORCA_ROBOT_MAX_SPEED = 0.6
RVO_EPSILON = 0.00001      # src/3rdparty/ervo_ros/include/ervo_ros/Definitions.h

# ---------------------------------------------------------------------------
# Social-force-model constants (Moussaid-Helbing as configured by pedsim).
# Reference: src/3rdparty/pedsimros/src/ped_agent.cpp:46-56, 319-331, 343,
#            426-428, 499, 564.
# ---------------------------------------------------------------------------
SFM_LAMBDA = 2.0
SFM_GAMMA = 0.35
SFM_N = 2.0
SFM_N_PRIME = 3.0
SFM_CUTOFF_DIST_SQ = 64.0
SFM_NEIGHBORHOOD_RANGE = 20.0
SFM_FACTOR_SOCIAL = 2.1
SFM_FACTOR_OBSTACLE = 1.0
SFM_FACTOR_DESIRED = 1.0
SFM_FACTOR_LOOKAHEAD = 1.0
SFM_OBSTACLE_SIGMA = 0.8
SFM_AGENT_RADIUS = 0.2
SFM_RELAXATION_TIME = 0.5
SFM_VEL_DECAY = 0.5        # v <- 0.5 * v + a * h   (ped_agent.cpp:564)
SFM_FIRST_WAYPOINT_RADIUS = 1.0  # pedscene.h:41 (goal waypoint radius)

# ---------------------------------------------------------------------------
# Pedestrian leg-gait model.
# Reference: src/img_env/src/agent.cpp:653-735.  ImgEnv constructs peds with
# the two-argument ctor (img_env.cpp:149), whose stride is 0.3 (agent.cpp:662).
# ---------------------------------------------------------------------------
GAIT_PHASES = 7
GAIT_STEP_LEN = 0.3
