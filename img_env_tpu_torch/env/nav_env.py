"""The core navigation environment (torch port of
``img_env_tpu.env.nav_env``): reset and step over ``WorldState``.

    env = NavEnv(cfg, device="cuda")
    state, obs = env.reset()
    state, obs, reward, done, info = env.step(state, actions)

One ``NavEnv`` owns the host-built statics (map, footprints, sampler spec,
sensor geometry) and their tensors on ``device``.  Step pipeline (ordering
matches ImgEnv::_step, img_env.cpp:421-525): beeps -> crowd (SFM, ORCA,
ERVO or dataset replay; gait) -> robot kinematics -> raster (kernel K1:
robots; peds' legs and bodies) and collision codes -> flat sensor pass:
FOV fill (K2), raycast, exact painter (K3, or K5 with
``paint_mode='block'``), self stamp, 48x48 resize -> ped vectors and ped
maps (K4) -> observation -> reward/done.  On a CUDA device the kernels
always run; on the CPU their plain-torch twins do.

The observation and the step also take states of S scenes (every tensor
with a leading [S] axis; ``parallel.BatchedNavEnv``): the raster of all
scenes is one K1 launch, and the sensor pass runs flat over the S*N robots,
one pass per sensor group (robots of one sensor placement; K2 and K3 once
per group), robot i reading the packed map of scene i // N.

Ported: robots and obstacles, pedestrians with the ``pedscene`` (SFM),
``rvoscene`` (ORCA), ``ervoscene`` (ORCA with the beep evacuation) or
``dataset`` (trajectory replay) crowd model or none, the reset's ``carry``,
``dataset`` and ``static_map`` arguments, per-robot sensor placements,
``use_laser`` on or off, and ``sensor_mode`` 'parity' or 'fast' (the same
pipeline on a view grid coarsened by ``fast_sensor_scale``).
``sensor_mode='reference'`` raises ``NotImplementedError``.  ``step_fn``
and the observation make no host syncs; the reset does (the sampler's
retries, the segment split).  On a CUDA device the step (advance, observe,
finish: ``step_scenes``) replays as one CUDA graph per shape
(``env/step_graph.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.constants import (
    ANGULAR_MAP_SIZE,
    CELL_FREE_MIN,
    LASER_MISS_DIST,
)
from img_env_tpu_torch.core.state import (
    CrowdAuxState,
    Observation,
    ObstacleState,
    PedState,
    RobotState,
    WorldState,
    map_tree,
)
from img_env_tpu_torch.crowd import common as crowd_common
from img_env_tpu_torch.crowd import gait as gait_mod
from img_env_tpu_torch.crowd import orca as orca_mod
from img_env_tpu_torch.crowd import sfm as sfm_mod
from img_env_tpu_torch.crowd.obstacle_split import split_segments
from img_env_tpu_torch.dynamics.kinematics import batched_robot_cmd
from img_env_tpu_torch.dynamics.limiter import LimiterParams
from img_env_tpu_torch.env import maps as maps_mod
from img_env_tpu_torch.env import observe, rewards
from img_env_tpu_torch.env.sampler import (
    SamplerSpec,
    ScenarioSample,
    obstacle_corners,
    sample_scenario_retry,
)
from img_env_tpu_torch.env.step_graph import StepGraphs
from img_env_tpu_torch.mpc.edt import edt2d_device
from img_env_tpu_torch.ops import f32
from img_env_tpu_torch.ops import painter as painter_mod
from img_env_tpu_torch.ops import polar as polar_mod
from img_env_tpu_torch.ops import raster
from img_env_tpu_torch.ops.footprint import circle_points, rectangle_points
from img_env_tpu_torch.ops.view import ViewParams, ViewStatics, own_view_cells
from img_env_tpu_torch.utils import statics_cache as scache
from img_env_tpu_torch.utils import trace


def _pad_clouds(clouds):
    pmax = max(max((c.shape[0] for c in clouds), default=1), 1)
    pts = np.zeros((len(clouds), pmax, 2), np.float32)
    msk = np.zeros((len(clouds), pmax), bool)
    for i, c in enumerate(clouds):
        pts[i, : c.shape[0]] = c
        msk[i, : c.shape[0]] = True
    return pts, msk


class EnvStatics(NamedTuple):
    """Host-precomputed constants (numpy)."""

    static_map: np.ndarray
    resolution: float
    robot_points: np.ndarray       # [N,P,2]
    robot_mask: np.ndarray         # [N,P]
    robot_radius: np.ndarray       # [N] last size element
    ped_body_points: np.ndarray    # [M,Q,2] circle-ped bodies
    ped_body_mask: np.ndarray
    ped_left_points: np.ndarray    # [M,L,2] leg clouds at leg-frame origin
    ped_left_mask: np.ndarray
    ped_right_points: np.ndarray
    ped_right_mask: np.ndarray
    ped_rest_left: np.ndarray      # [M,2] configured leg offsets
    ped_rest_right: np.ndarray
    ped_is_leg: np.ndarray         # [M]
    ped_r: np.ndarray              # [M] body radius, rounded 2dp
    ped_max_speed: np.ndarray      # [M]
    ped_wp_xy: np.ndarray          # [M,W,2] scripted waypoints (pad 0)
    ped_wp_r: np.ndarray           # [M,W] pedsim waypoint radii
    ped_wp_count: np.ndarray       # [M] scripted count (0 -> goal/go_back)
    obs_points: np.ndarray         # [O,P,2]
    obs_point_dist: np.ndarray     # [O,P]
    obs_base_mask: np.ndarray      # [O,P]
    obs_is_circle: np.ndarray      # [O]
    view_params: ViewParams
    view_statics: ViewStatics
    polar: polar_mod.PolarStatics
    own_slots: np.ndarray          # [N,P] sorted-slot footprint stamps
    own_slots_ok: np.ndarray       # [N,P]
    sampler: SamplerSpec
    limiter_v: LimiterParams
    limiter_w: LimiterParams
    painter: Optional[painter_mod.PainterStatics]   # None without lasers
    orca_cfg: orca_mod.OrcaConfig
    sensor_groups: tuple = ()      # SensorGroup per distinct placement;
                                   # view_statics .. painter are group 0's


class SensorGroup(NamedTuple):
    """The robots of one sensor placement (``sensor_cfgs``, the
    reference's per-robot ``sensor_base_``, img_env.cpp:131-132) and their
    sensor geometry: one flat sensor pass per group."""

    idx: np.ndarray                # [k] int32 in-scene robot indices
    sensor: Tuple[float, float]
    view_statics: ViewStatics
    polar: polar_mod.PolarStatics  # on the fast grid in sensor_mode 'fast'
    painter: Optional[painter_mod.PainterStatics]
    own_slots: np.ndarray          # [k,P] sorted-slot footprint stamps
    own_slots_ok: np.ndarray       # [k,P]


SCENES = ("", "pedscene", "rvoscene", "ervoscene", "dataset")
SENSOR_MODES = ("parity", "fast")


def check_supported(cfg: EnvConfig) -> None:
    """Raise NotImplementedError for what this port does not run, and
    ValueError for a crowd model or sensor mode that does not exist.
    ``num_scenes`` is read by the batch facades, not here, as in the JAX
    package."""
    scene = cfg.ped_sim.type
    if cfg.ped_sim.total > 0 and scene not in SCENES:
        raise ValueError(f"unknown crowd model ped_sim.type {scene!r}")
    if cfg.sensor_mode == "reference":
        raise NotImplementedError(
            "sensor_mode 'reference' (the per-robot gather the JAX package "
            "keeps for cross-checks) is not ported")
    if cfg.sensor_mode not in SENSOR_MODES:
        raise ValueError(f"unknown sensor_mode {cfg.sensor_mode!r}")
    if cfg.robot.total < 1:
        raise ValueError("at least one robot")


def _ped_statics(cfg: EnvConfig):
    """Ped clouds, leg rest offsets, radii, speeds and scripted waypoints
    (the ped part of the JAX package's ``build_statics``)."""
    m = cfg.ped_sim.total
    body, left, right = [], [], []
    rest_l = np.zeros((m, 2), np.float32)
    rest_r = np.zeros((m, 2), np.float32)
    is_leg = np.zeros(m, bool)
    ped_r = np.zeros(m, np.float32)
    ped_ms = np.zeros(m, np.float32)
    empty = np.zeros((0, 2), np.float32)
    for j in range(m):
        sz = list(cfg.ped_sim.size[j])
        ped_ms[j] = cfg.ped_sim.max_speed[j]
        if cfg.ped_sim.shape[j] == "leg":
            # init_ped duplicates the left leg spec mirrored in y
            # (reset_helper.py:400-404): sizes -> [x, y, r, x, -y, r]
            full = sz + [sz[0], -sz[1], sz[2]]
            left.append(circle_points(0.0, 0.0, full[2]))
            right.append(circle_points(0.0, 0.0, full[5]))
            body.append(empty)
            rest_l[j] = full[0:2]
            rest_r[j] = full[3:5]
            is_leg[j] = True
            ped_r[j] = round(full[2], 2)
        else:
            body.append(circle_points(sz[0], sz[1], sz[2]))
            left.append(empty)
            right.append(empty)
            ped_r[j] = round(sz[2], 2)
    # scripted waypoint lists (Agent.trajectory, img_env.cpp:220-250)
    wp_lists = [list(cfg.ped_sim.waypoints[j]) if cfg.ped_sim.waypoints
                else [] for j in range(m)]
    wmax = max([2] + [len(w) for w in wp_lists])
    wp_xy = np.zeros((m, wmax, 2), np.float64)
    wp_r = np.zeros((m, wmax), np.float64)
    wp_cnt = np.zeros(m, np.int64)
    for j in range(m):
        for k, wpt in enumerate(wp_lists[j]):
            wp_xy[j, k] = wpt[0], wpt[1]
            wp_r[j, k] = wpt[2] if len(wpt) > 2 else 0.0
        wp_cnt[j] = len(wp_lists[j])
    clouds = [_pad_clouds(c if m else [empty]) for c in (body, left, right)]
    if m == 0:
        clouds = [(p[:0], k[:0]) for p, k in clouds]
    (pb, pbm), (pl, plm), (pr, prm) = clouds
    return dict(
        ped_body_points=pb, ped_body_mask=pbm,
        ped_left_points=pl, ped_left_mask=plm,
        ped_right_points=pr, ped_right_mask=prm,
        ped_rest_left=rest_l, ped_rest_right=rest_r,
        ped_is_leg=is_leg, ped_r=ped_r, ped_max_speed=ped_ms,
        ped_wp_xy=wp_xy, ped_wp_r=wp_r, ped_wp_count=wp_cnt)


def build_statics(cfg: EnvConfig) -> EnvStatics:
    check_supported(cfg)
    static_map = maps_mod.load_static_map(cfg)
    res = float(cfg.view_map_resolution)
    n, o = cfg.robot.total, cfg.object.total
    if n >= 4096:
        # the id-packed sensor map carries robot ids <= 4095
        raise ValueError("at most 4095 robots per scene (id-packed map)")

    rob_clouds = []
    rob_radius = np.zeros(n, np.float32)
    for i in range(n):
        sh, sz = cfg.robot.shape[i], cfg.robot.size[i]
        if sh == "circle":
            rob_clouds.append(circle_points(sz[0], sz[1], sz[2]))
        else:
            rob_clouds.append(rectangle_points(sz[0], sz[1], sz[2], sz[3]))
        rob_radius[i] = sz[-1]
    robot_points, robot_mask = _pad_clouds(rob_clouds)

    obs_clouds, obs_dists, obs_circ = [], [], np.zeros(o, bool)
    for k in range(o):
        sh = cfg.object.shape[k]
        sr = cfg.object.size_range[k]
        if sh == "circle":
            c = circle_points(0.0, 0.0, max(sr[0], sr[1]))
            obs_clouds.append(c)
            obs_dists.append(np.hypot(c[:, 0], c[:, 1]))
            obs_circ[k] = True
        else:
            c = rectangle_points(sr[0], sr[1], sr[2], sr[3])
            obs_clouds.append(c)
            obs_dists.append(np.zeros(c.shape[0], np.float32))
    if o == 0:
        obs_clouds = [np.zeros((1, 2), np.float32)]
        obs_dists = [np.zeros(1, np.float32)]
    op, om = _pad_clouds(obs_clouds)
    od = np.zeros(op.shape[:2], np.float32)
    for k, dd in enumerate(obs_dists[: op.shape[0]]):
        od[k, : dd.shape[0]] = dd
    if o == 0:
        op, om, od = op[:0], om[:0], od[:0]

    vp = ViewParams.from_config(cfg)
    # 'fast' runs the same polar pipeline on a view grid coarsened by
    # fast_sensor_scale: fewer fill reads and raycast rows, lasers
    # quantized to the coarse cell (nav_env.py:233-241 of the JAX package)
    if cfg.sensor_mode == "fast":
        sc = max(int(cfg.fast_sensor_scale), 1)
        vp_polar = vp._replace(hpx=vp.hpx // sc, wpx=vp.wpx // sc,
                               resolution=vp.resolution * sc)
    else:
        vp_polar = vp
    # robots grouped by distinct sensor placement in first-seen order
    # (reset_helper.py:383-384): one sensor pass per group
    sensors = [tuple(float(v) for v in cfg.robot.sensor_cfgs[i])
               for i in range(n)]
    groups = []
    for u in dict.fromkeys(sensors):
        idx = np.asarray([i for i in range(n) if sensors[i] == u], np.int32)
        ps_g = polar_mod.PolarStatics.build(
            vp_polar, u, image_size=tuple(cfg.image_size))
        oslots = np.full((len(idx),) + robot_mask.shape[1:],
                         ps_g.n_slots - 1, np.int32)
        ook = np.zeros((len(idx),) + robot_mask.shape[1:], bool)
        for gi, i in enumerate(idx):
            c_p, m_p = own_view_cells(robot_points[i], robot_mask[i],
                                      vp_polar)
            oslots[gi], ook[gi] = polar_mod.own_slots_from_cells(
                ps_g, c_p, m_p)
        groups.append(SensorGroup(
            idx=idx, sensor=u, view_statics=ViewStatics.build(vp, u),
            polar=ps_g,
            painter=(painter_mod.PainterStatics.build(ps_g, u)
                     if vp.use_laser else None),
            own_slots=oslots, own_slots_ok=ook))
    g0 = groups[0]
    return EnvStatics(
        static_map=static_map, resolution=res,
        robot_points=robot_points, robot_mask=robot_mask,
        robot_radius=rob_radius, **_ped_statics(cfg),
        obs_points=op, obs_point_dist=od, obs_base_mask=om,
        obs_is_circle=obs_circ,
        view_params=vp, view_statics=g0.view_statics, polar=g0.polar,
        own_slots=g0.own_slots, own_slots_ok=g0.own_slots_ok,
        sampler=SamplerSpec.from_config(cfg),
        limiter_v=LimiterParams.from_config(cfg.speed_limiter_v),
        limiter_w=LimiterParams.from_config(cfg.speed_limiter_w),
        painter=g0.painter,
        orca_cfg=orca_mod.OrcaConfig(
            time_step=float(cfg.control_hz),
            max_obs_segments=int(cfg.max_obs_segments)),
        sensor_groups=tuple(groups),
    )


class SensorTables(NamedTuple):
    """Everything the step reads, as tensors on the environment's device
    (``polar`` and ``painter``: sensor group 0's)."""

    polar: polar_mod.PolarTables
    painter: Optional[painter_mod.PainterTables]   # None without lasers
    robot_points: torch.Tensor     # [N,P,2] f32
    robot_mask: torch.Tensor       # [N,P] bool
    beam_dirs: torch.Tensor        # [R,2] f32 (cos, sin) of beam angles


class GroupTables(NamedTuple):
    """One sensor group's tables on the device."""

    polar: polar_mod.PolarTables   # own_mask: [k, P'] the group's robots
    painter: Optional[painter_mod.PainterTables]
    idx: torch.Tensor              # [k] int64 in-scene robot indices
    rids: torch.Tensor             # [k] int32 in-scene ids (idx + 1)


class CrowdTables(NamedTuple):
    """The ped statics the crowd step and the observation read, on the
    environment's device (fields as in ``EnvStatics``)."""

    body_points: torch.Tensor      # [M,Q,2] f32
    body_mask: torch.Tensor        # [M,Q] bool
    left_points: torch.Tensor      # [M,L,2] f32
    left_mask: torch.Tensor
    right_points: torch.Tensor
    right_mask: torch.Tensor
    rest_left: torch.Tensor        # [M,2] f32
    rest_right: torch.Tensor
    ped_r: torch.Tensor            # [M] f32
    max_speed: torch.Tensor        # [M] f32
    robot_radius: torch.Tensor     # [N] f32
    wp_r: torch.Tensor             # [M,1+W] f32 pedsim queue radii: goal
                                   # (r = 1), then the scripted waypoints
    sfm_vmax: torch.Tensor         # [M+N] f32: peds, then robot mirrors
    sfm_valid: torch.Tensor        # [M+N] bool
    orca_radius: torch.Tensor      # [M] f32: every ped's ORCA radius


def make_crowd_tables(st: EnvStatics, cfg: EnvConfig, device) -> CrowdTables:
    m, n = cfg.ped_sim.total, cfg.robot.total
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    b = lambda a: torch.as_tensor(np.asarray(a, bool), device=device)
    scripted = (st.ped_wp_count > 0)[:, None]
    traj_r = np.where(scripted, st.ped_wp_r, 0.0)
    rel = int(cfg.relation_ped_robo) == 1
    return CrowdTables(
        body_points=f32(st.ped_body_points), body_mask=b(st.ped_body_mask),
        left_points=f32(st.ped_left_points), left_mask=b(st.ped_left_mask),
        right_points=f32(st.ped_right_points),
        right_mask=b(st.ped_right_mask),
        rest_left=f32(st.ped_rest_left), rest_right=f32(st.ped_rest_right),
        ped_r=f32(st.ped_r), max_speed=f32(st.ped_max_speed),
        robot_radius=f32(st.robot_radius),
        wp_r=f32(np.concatenate([np.ones((m, 1)), traj_r], axis=1)),
        sfm_vmax=f32(np.concatenate([st.ped_max_speed, np.full(n, 1.2)])),
        sfm_valid=b(np.concatenate([np.ones(m, bool), np.full(n, rel)])),
        orca_radius=f32(np.full(m, st.orca_cfg.radius)))


class NavEnv:
    """Single-scene environment on ``device``: the card by default; CPU
    callers (the tests) pass 'cpu'."""

    def __init__(self, cfg: EnvConfig, device="cuda", seed: int = 0):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "NavEnv runs on a CUDA device by default and none is "
                    "available; pass device='cpu' to run on the CPU")
            if cfg.fill_mode == "gather" or cfg.paint_mode == "xla":
                raise NotImplementedError(
                    "on CUDA the fill and painter always run their kernels; "
                    "fill_mode='gather' / paint_mode='xla' are CPU-only")
        # opt-in warm start: the statics are a pure function of (cfg, map,
        # package source); IMG_ENV_TPU_STATICS_CACHE names a directory
        # that keeps them across processes (utils/statics_cache.py)
        self._cache_key = (
            scache.cache_key(cfg, cfg.resolve_map_path())
            if scache.cache_dir() else None)
        with trace.span("setup.statics"):
            self.statics = st = scache.cached(
                self._cache_key and "st-" + self._cache_key,
                lambda: build_statics(cfg),
                lambda x: isinstance(x, EnvStatics))
        raster.check_footprint_span(st.robot_points, st.resolution)
        dev = self.device
        self.group_tables = tuple(self._group_tables(gi, g)
                                  for gi, g in enumerate(st.sensor_groups))
        # XLA folds the JAX package's cos/sin of these constant float32
        # angles at compile time, correctly rounded: float64 cos/sin of the
        # float32 angle, rounded to float32
        ang = torch.as_tensor(st.view_statics.laser.angles,
                              dtype=torch.float32, device=dev).double()
        self.tables = SensorTables(
            polar=self.group_tables[0].polar,
            painter=self.group_tables[0].painter,
            robot_points=torch.as_tensor(st.robot_points, device=dev),
            robot_mask=torch.as_tensor(st.robot_mask, device=dev),
            beam_dirs=torch.stack([torch.cos(ang), torch.sin(ang)],
                                  -1).float())
        self.crowd = make_crowd_tables(st, cfg, dev)
        self.scene_type = (cfg.ped_sim.type if cfg.ped_sim.total > 0
                           else "none")
        self.static_map = torch.as_tensor(st.static_map, device=dev)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        self._graphs = StepGraphs()

    def _group_tables(self, gi: int, g: SensorGroup) -> GroupTables:
        """Sensor group ``gi``'s device tables: its polar tables with its
        robots' self-stamp masks, and the painter's launch table (K5's
        64-slot blocks for paint_mode='block', K3's per-slot visit lists
        otherwise, through the statics cache), built from the group's
        parity or fast statics."""
        dev = self.device
        own_mask = polar_mod.own_mask_sorted(g.polar, g.own_slots,
                                             g.own_slots_ok)
        painter = None
        if g.painter is not None:
            if self.cfg.paint_mode == "block":
                kind, build = "kbl", lambda: painter_mod.PaintBlocks.build(
                    g.painter, self.statics.view_params.range_total)
                cls = painter_mod.PaintBlocks
            else:
                kind, build = "kst", lambda: painter_mod.PaintSlots.build(
                    g.painter)
                cls = painter_mod.PaintSlots
            layout = scache.cached(
                self._cache_key and f"{kind}{gi or ''}-{self._cache_key}",
                build, lambda x: isinstance(x, cls))
            painter = painter_mod.make_painter_tables(g.painter, layout, dev)
        idx = torch.as_tensor(g.idx, dtype=torch.int64, device=dev)
        return GroupTables(
            polar=polar_mod.make_tables(g.polar, own_mask, dev),
            painter=painter, idx=idx, rids=(idx + 1).to(torch.int32))

    # ------------------------------------------------------------------
    # reset
    # ------------------------------------------------------------------
    def sample_scenario(self) -> ScenarioSample:
        """Draw one episode layout from the environment's generator."""
        return sample_scenario_retry(self.statics.sampler, self.generator,
                                     self.device)

    def reset_fn(self, sample: Optional[ScenarioSample] = None, carry=None,
                 dataset=None, static_map=None):
        state = self.reset_state_fn(sample, carry, dataset, static_map)
        return self._observe(state)

    def reset_state_fn(self, sample: Optional[ScenarioSample] = None,
                       carry: Optional[WorldState] = None,
                       dataset=None, static_map=None) -> WorldState:
        """Map, EDT, robot and ped state for an episode, without the sensor
        pass.  ``sample``: an injected layout (default: a fresh draw).
        ``carry``: the previous episode's state, whose robots' command
        before last, ped velocities, gait and robot crowd velocities carry
        over.  ``dataset``: (traj [M,T,2], vel [M,T,2], length [M]) replay
        arrays for the ``dataset`` scene (ETH/UCY, img_env.cpp:361-386;
        datasets/pedestrians.py); the peds then start from frame 0.
        ``static_map``: a uint8 base map for this episode in place of the
        configured one (scenes of one batch holding different worlds, padded
        to one shape; the configured map's resolution)."""
        if sample is None:
            sample = self.sample_scenario()
        return self.reset_from_sample(sample, carry, dataset, static_map)

    def reset_from_sample(self, sc: ScenarioSample,
                          carry: Optional[WorldState] = None,
                          dataset=None, static_map=None) -> WorldState:
        st = self.statics
        cfg = self.cfg
        dev = self.device
        n, m = cfg.robot.total, cfg.ped_sim.total
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        obs_pose = f32(sc.obs_pose)
        circle_r = f32(sc.obs_circle_r)
        init = f32(sc.init_poses)
        target = f32(sc.target_poses)

        # obstacle map: stamp the sampled footprints into the static map
        base_mask = torch.as_tensor(st.obs_base_mask, device=dev)
        is_circ = torch.as_tensor(st.obs_is_circle, device=dev)
        dyn_mask = base_mask & (~is_circ[:, None]
                                | (f32(st.obs_point_dist)
                                   <= circle_r[:, None]))
        base_map = (self.static_map if static_map is None
                    else torch.as_tensor(static_map, dtype=torch.uint8,
                                         device=dev))
        obs_map = raster.draw_obstacles(
            base_map, st.resolution, obs_pose, f32(st.obs_points), dyn_mask)
        aabb = obstacle_corners(obs_pose, st.sampler, circle_r)

        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
        zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
        robots = RobotState(
            pose=init[:n], goal=target[:n, :2], goal_yaw=init[:n, 2],
            vw_last0=z(n, 2),
            vw_last1=carry.robots.vw_last1 if carry is not None else z(n, 2),
            vel_world=z(n, 2), collision=zi(n), arrive=zb(n), beep=zi(n))
        peds = self._reset_peds(init[n:], target[n:], sc.go_back, carry,
                                dataset)

        # rvoscene/ervoscene: RVO2's kd-tree segment split, once per
        # episode (processObs; KdTree.cpp:131-257)
        segs = None
        if (self.scene_type in ("rvoscene", "ervoscene") and m > 0
                and not cfg.ped_sim.ignore_obstacle and aabb.shape[0] > 0):
            with trace.span("reset.split"):
                segs, _ = split_segments(aabb, torch.ones(
                    aabb.shape[0], dtype=torch.bool, device=dev))
        obstacles = ObstacleState(
            pose=obs_pose, size=z(obs_pose.shape[0], 4),
            is_circle=is_circ, aabb=aabb, segs=segs)

        # episode clearance field (static map + sampled obstacles), which
        # the MPC cost reads
        clip = int(min(256, max(64, math.ceil(2.0 / st.resolution))))
        occupied = obs_map < CELL_FREE_MIN
        with trace.span("reset.edt"):
            obs_edt = edt2d_device(occupied, st.resolution, clip_cells=clip)
        return WorldState(
            robots=robots, peds=peds,
            crowd_aux=CrowdAuxState(
                robot_vel=(carry.crowd_aux.robot_vel if carry is not None
                           else z(n, 2))),
            obstacles=obstacles, obs_map=obs_map, obs_edt=obs_edt,
            step=torch.zeros((), dtype=torch.int32, device=dev),
            prev_goal_dist=z(n),
            has_prev_dist=torch.zeros((), dtype=torch.bool, device=dev))

    def _reset_peds(self, init, target, go_back, carry=None,
                    dataset=None) -> PedState:
        """Ped state at reset (nav_env.py of the JAX package): the goal,
        then the start again when going back, or the scripted waypoints
        (Agent.trajectory, img_env.cpp:243-250; reset_helper.py:337-342);
        legs at their rest offsets; the SFM queue at its first waypoint.
        A replayed dataset sets the start pose and velocity (frame 0); a
        carried state, the velocity (without a dataset) and the gait."""
        st = self.statics
        ct = self.crowd
        dev = self.device
        m = init.shape[0]
        wmax = int(st.ped_wp_xy.shape[1])
        goal = target[:, :2]
        traj = torch.stack(
            [goal, torch.where(go_back[:, None], init[:, :2], goal)], 1)
        traj = torch.cat([traj, traj.new_zeros((m, wmax - 2, 2))], 1)
        scripted = torch.as_tensor(st.ped_wp_count > 0, device=dev)
        traj = torch.where(scripted[:, None, None],
                           torch.as_tensor(st.ped_wp_xy, dtype=torch.float32,
                                           device=dev), traj)
        back = go_back.to(torch.int32) + 1
        traj_len = torch.where(
            scripted, torch.as_tensor(st.ped_wp_count, dtype=torch.int32,
                                      device=dev), back)
        zi = torch.zeros((m,), dtype=torch.int32, device=dev)
        if dataset is not None:
            ds_traj, ds_vel = (torch.as_tensor(x, dtype=torch.float32,
                                               device=dev)
                               for x in dataset[:2])
            ds_len = torch.as_tensor(dataset[2], dtype=torch.int32,
                                     device=dev)
            v0 = ds_vel[:, 0]
            init = torch.cat([ds_traj[:, 0],
                              torch.atan2(v0[:, 1:2], v0[:, 0:1])], -1)
            vel = v0
        else:
            ds_traj = init.new_zeros((m, 1, 2))
            ds_vel = init.new_zeros((m, 1, 2))
            ds_len = torch.ones((m,), dtype=torch.int32, device=dev)
            vel = (carry.peds.vel if carry is not None
                   else init.new_zeros((m, 2)))
        return PedState(
            pos=init[:, :2], yaw=init[:, 2], prev_pos=init[:, :2], vel=vel,
            goal=goal, traj=traj, traj_len=traj_len, traj_idx=zi,
            gait_state=carry.peds.gait_state if carry is not None else zi,
            gait_residual=(carry.peds.gait_residual if carry is not None
                           else init.new_zeros((m,))),
            leg_offset=torch.stack([ct.rest_left, ct.rest_right], 1),
            sfm_wp_idx=zi,
            sfm_has_dest=torch.ones((m,), dtype=torch.bool, device=dev),
            sfm_lastdest=torch.full((m,), -1, dtype=torch.int32, device=dev),
            dataset_traj=ds_traj, dataset_vel=ds_vel, dataset_len=ds_len)

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------
    def step_fn(self, state: WorldState, actions, beep_u=None):
        """actions: [N,3] (v, w, v_y/beep).  ``beep_u``: optional [N]
        uniform draw for the beep response (default: the generator)."""
        with trace.span("env.step"):
            new_state, obs, reward, done, info = self.step_scenes(
                _add_scene_axis(state), actions[None],
                None if beep_u is None else beep_u[None])
            return (_drop_scene_axis(new_state),
                    map_tree(lambda x: x[0], obs), reward[0], done[0],
                    {k: v[0] for k, v in info.items()})

    def step_scenes(self, states: WorldState, actions, beep_u=None):
        """``step_fn`` over S scenes (states with a leading [S] axis,
        actions [S, N, 3], beep_u [S, N]): advance, observe and finish.  On
        a CUDA device the three replay as one CUDA graph per shape
        (``env/step_graph.py``): the same kernels on the same data, so the
        same bits.  The beep draw the eager step makes from the generator
        (``crowd_common.sample_beeps``) is made here, before the graph, and
        passed in."""
        if self.device.type != "cuda":
            return self._step_scenes(states, actions, beep_u)
        drawn = beep_u is None
        if drawn:
            pose = states.robots.pose
            s, n = pose.shape[:2]
            beep_u = torch.rand(s * n, generator=self.generator,
                                device=pose.device,
                                dtype=pose.dtype).reshape(s, n)
        return self._graphs(self._step_scenes, (states, actions, beep_u),
                            drawn)

    def _step_scenes(self, states: WorldState, actions, beep_u=None):
        """The eager step of S scenes (``step_scenes``)."""
        states, alive, beeps = self.advance_scenes(states, actions, beep_u)
        states, obs = self.observe_scenes(states)
        return self.finish_step(states, obs, alive, beeps)

    @staticmethod
    def finish_step(new_state, obs: Observation, alive, beeps):
        """(state, obs, reward, done, info) of an observed step."""
        reward = rewards.base_reward(obs.is_collisions, obs.is_arrives)
        done = rewards.compute_dones(obs.is_collisions, obs.is_arrives)
        info = {
            "dones_info": torch.zeros_like(obs.is_collisions),
            "beeps": beeps,
            "alive": alive,
        }
        return new_state, obs, reward, done, info

    def advance_fn(self, state: WorldState, actions, beep_u=None):
        """Pre-observation step: beeps, robot dynamics and bookkeeping.
        Returns (state-before-observe, alive mask, beeps)."""
        states, alive, beeps = self.advance_scenes(
            _add_scene_axis(state), actions[None],
            None if beep_u is None else beep_u[None])
        return _drop_scene_axis(states), alive[0], beeps[0]

    @trace.spanned("env.advance")
    def advance_scenes(self, states: WorldState, actions, beep_u=None):
        """``advance_fn`` over S scenes: states with a leading [S] axis,
        actions [S, N, 3], beep_u [S, N] (default: S*N draws from the
        generator).  The beeps and the robot dynamics are elementwise and
        run flat over the S*N robots; the crowd steps every scene at once
        (``_crowd_step``)."""
        st = self.statics
        cfg = self.cfg
        r = states.robots
        s, n = r.pose.shape[:2]
        flat = lambda x: x.reshape((s * n,) + x.shape[2:])
        dones_prev = rewards.compute_dones(r.collision,
                                           r.arrive.to(torch.int32))
        alive = dones_prev == 0
        zero = torch.zeros_like(actions[..., 0])
        v = torch.where(alive, actions[..., 0], zero)
        w = torch.where(alive, actions[..., 1], zero)
        v_y = torch.where(alive, actions[..., 2], zero)

        # crowd step first, from the previous robot mirrors; the beep
        # sources feed the ERVO evacuation term
        sources, radii, beeps = crowd_common.sample_beeps(
            flat(r.pose), flat(v_y), float(cfg.beep_r), float(cfg.ped_ca_p),
            u=None if beep_u is None else flat(beep_u),
            generator=self.generator)
        if cfg.ped_sim.total == 0 or self.scene_type in ("none", ""):
            peds, crowd_aux = states.peds, states.crowd_aux
        else:
            with trace.span("env.crowd"):
                peds, crowd_aux = self._crowd_step(
                    states, sources.reshape(s, n, 2), radii.reshape(s, n))
        unflat = lambda x: x.reshape((s, n) + x.shape[1:])
        with trace.span("env.dynamics"):
            pose, l0, l1, vel, arrive_new = (
                unflat(x) for x in batched_robot_cmd(
                    flat(r.pose), flat(r.goal), flat(r.vw_last0),
                    flat(r.vw_last1), flat(r.vel_world), flat(v), flat(w),
                    flat(v_y), flat(alive), st.limiter_v, st.limiter_w,
                    float(cfg.control_hz), cfg.n_substeps, cfg.robot_type))
        beeps = unflat(beeps)
        robots = RobotState(
            pose=pose, goal=r.goal, goal_yaw=r.goal_yaw,
            vw_last0=l0, vw_last1=l1, vel_world=vel,
            collision=r.collision, arrive=r.arrive | arrive_new, beep=beeps)
        return (states._replace(robots=robots, peds=peds,
                                crowd_aux=crowd_aux, step=states.step + 1),
                alive, beeps)

    def _crowd_step(self, states: WorldState, sources, radii):
        """Peds and the robot mirrors' crowd velocities of S scenes after
        one crowd step (the JAX package's ``_crowd_step``, vmapped over the
        scenes): the crowd model, then the gait, on states with a leading
        [S] axis.  ``sources``/``radii``: this step's beeps ([S,N,2],
        [S,N]).  Every crowd model steps all scenes at once (counter
        ``crowd.scenes`` +S): SFM, the dataset replay, and ORCA in one
        solve under one ``crowd.orca`` span (counter ``orca.agents``
        +S*M); the goals and the gait are batched around them."""
        peds, aux = states.peds, states.crowd_aux
        s = peds.pos.shape[0]
        goals, new_idx = crowd_common.advance_traj_goals(
            peds.pos, peds.traj, peds.traj_len, peds.traj_idx)
        trace.count("crowd.scenes", s)
        if self.scene_type == "pedscene":
            new_pos, new_vel, peds, aux = self._sfm_step(states)
        elif self.scene_type == "dataset":
            # verbatim replay: the k-th step after reset replays index k
            # (step_ increments only at the end of _step,
            # img_env.cpp:361-386, 518)
            new_pos, new_vel, _ = crowd_common.dataset_replay(
                states.step, peds.dataset_traj, peds.dataset_vel,
                peds.dataset_len)
        else:   # rvoscene / ervoscene
            trace.count("orca.agents", s * peds.pos.shape[1])
            if self.scene_type != "ervoscene":
                sources = radii = None
            with trace.span("crowd.orca"):
                new_pos, new_vel = self._orca_step(states, goals, sources,
                                                   radii)
        ct = self.crowd
        yaw = torch.atan2(new_vel[..., 1], new_vel[..., 0])
        move = f32.sqrt(((new_pos - peds.pos) ** 2).sum(-1))
        gstate, gres, legs = gait_mod.update_gait(
            peds.gait_state, peds.gait_residual, move, ct.rest_left,
            ct.rest_right)
        return peds._replace(
            pos=new_pos, yaw=yaw, prev_pos=peds.pos, vel=new_vel,
            traj_idx=new_idx, gait_state=gstate, gait_residual=gres,
            leg_offset=legs), aux

    def _orca_step(self, states: WorldState, goals, sources, radii):
        """ORCA over the peds of S scenes (states with a leading [S] axis,
        goals [S,M,2]; beep ``sources``/``radii`` [S,N,2]/[S,N] or None),
        each scene with its robots as neighbours when
        ``relation_ped_robo`` is 1 (their world velocities), against its
        reset's split segments, or the raw rectangle edges when the reset
        built none.  Every ped solves with the ORCA radius (0.5), not its
        body radius."""
        cfg = self.cfg
        ct = self.crowd
        m = cfg.ped_sim.total
        peds, rob = states.peds, states.robots
        seg = states.obstacles.segs
        if seg is None:
            aabb = states.obstacles.aabb                # [S, O, 4]
            seg = orca_mod.segments_from_aabbs(aabb, torch.full(
                aabb.shape[:-1], not cfg.ped_sim.ignore_obstacle,
                dtype=torch.bool, device=self.device))
        rel = int(cfg.relation_ped_robo) == 1
        n_nb = cfg.robot.total if rel else 0
        return orca_mod.orca_step(
            peds.pos, peds.vel, orca_mod.pref_velocity(peds.pos, goals),
            ct.orca_radius, ct.max_speed, ct.sfm_valid[:m],
            rob.pose[:, :n_nb, :2], rob.vel_world[:, :n_nb],
            ct.sfm_valid[m:m + n_nb], self.statics.orca_cfg, seg,
            evac_sources=sources, evac_radii=radii)

    def _sfm_step(self, states: WorldState):
        """The pedscene model over S scenes: in each, peds + robot mirrors
        as one SFM population [S, M+N] against the scene's own obstacle
        segments; the pedsim queue is [goal (r=1)] + trajectory
        (pedscene.h:39-47) and its fetch head travels in the sfm_lastdest
        slot.  Returns (pos, vel, peds with the queue state, crowd aux)."""
        cfg = self.cfg
        ct = self.crowd
        m, n = cfg.ped_sim.total, cfg.robot.total
        peds, aux, rob = states.peds, states.crowd_aux, states.robots
        s = peds.pos.shape[0]
        zi = torch.zeros((s, n), dtype=torch.int32, device=self.device)
        wq = 1 + peds.traj.shape[-2]
        wp_r = torch.cat([ct.wp_r, ct.wp_r.new_zeros((n, wq))])
        wp = sfm_mod.SfmWaypointState(
            wp_xy=torch.cat([
                torch.cat([peds.goal[:, :, None], peds.traj], 2),
                peds.traj.new_zeros((s, n, wq, 2))], 1),
            wp_r=wp_r.expand((s,) + wp_r.shape),
            wp_len=torch.cat([1 + peds.traj_len, zi], 1),
            dest_idx=torch.cat([peds.sfm_wp_idx, zi], 1),
            head=torch.cat([peds.sfm_lastdest, zi], 1),
            has_dest=torch.cat([peds.sfm_has_dest,
                                torch.zeros_like(zi, dtype=torch.bool)], 1))
        aabb = states.obstacles.aabb                    # [S, O, 4]
        seg_valid = torch.full((aabb.shape[-2],),
                               not cfg.ped_sim.ignore_obstacle,
                               dtype=torch.bool, device=self.device)
        all_pos, all_vel, new_wp = sfm_mod.sfm_step(
            torch.cat([peds.pos, rob.pose[..., :2]], 1),
            torch.cat([peds.vel, aux.robot_vel], 1),
            ct.sfm_vmax, ct.sfm_valid, wp, aabb[..., :2], aabb[..., 2:],
            seg_valid, float(cfg.control_hz))
        peds = peds._replace(sfm_wp_idx=new_wp.dest_idx[:, :m],
                             sfm_has_dest=new_wp.has_dest[:, :m],
                             sfm_lastdest=new_wp.head[:, :m])
        return (all_pos[:, :m], all_vel[:, :m], peds,
                CrowdAuxState(robot_vel=all_vel[:, m:]))

    # ------------------------------------------------------------------
    def _sensor_pass(self, packed, poses):
        """The flat sensor pipeline over robots.  packed: the id-packed
        maps [S, H, W]; poses: [S*N, 3] scene-major.  Returns
        (sensor_maps [S*N, h, w], hits [S*N, R], angular [S*N, 72])."""
        groups = self.group_tables
        if len(groups) == 1:
            return self._group_pass(self.statics.sensor_groups[0],
                                    groups[0], packed, poses, None)
        s = packed.shape[0]
        n = poses.shape[0] // s
        outs, order = [], []
        for g, t in zip(self.statics.sensor_groups, groups):
            # the group's robots of every scene, scene-major
            rows = (torch.arange(s, device=poses.device)[:, None] * n
                    + t.idx[None]).reshape(-1)
            order.append(rows)
            outs.append(self._group_pass(g, t, packed, poses[rows],
                                         t.rids.repeat(s)))
        # back to robot order (nav_env.py:994-998 of the JAX package)
        inv = torch.argsort(torch.cat(order))
        return tuple(torch.cat(parts)[inv] for parts in zip(*outs))

    def _group_pass(self, g: SensorGroup, t: GroupTables, packed, poses,
                    rids):
        """One sensor group's pass: K2 over its robots of every scene
        (``rids``: their in-scene ids, None for all robots in order), the
        raycast and K3 (or K5) with the group's tables, or the plain views
        without lasers; the self stamp; the resize."""
        st = self.statics
        vp = st.view_params
        b = poses.shape[0]
        occ = polar_mod.fill_sorted(g.polar, t.polar, packed, poses,
                                    st.resolution, rids)
        if vp.use_laser:
            hits, angular, aux = polar_mod.raycast_batched(g.polar, t.polar,
                                                           occ)
            s_hit, s_tail = painter_mod.hit_steps(g.painter, t.painter, *aux)
            vals = painter_mod.paint(g.painter, t.painter, s_hit, s_tail)
        else:
            hits = torch.full((b, vp.range_total), LASER_MISS_DIST,
                              device=poses.device)
            angular = torch.full((b, ANGULAR_MAP_SIZE), vp.max_dist,
                                 device=poses.device)
            inside = polar_mod.inside_sorted(g.polar, t.polar,
                                             packed.shape[-2:], poses,
                                             st.resolution)
            vals = polar_mod.plain_values_sorted(t.polar, occ, inside)
        # the group's per-robot self-stamp masks tile over the scenes
        own = t.polar.own_mask
        vals = polar_mod.stamp_self_mask(
            vals.reshape(-1, own.shape[0], vals.shape[-1]), own[None]
        ).reshape(b, -1)
        sensor_maps = polar_mod.sensor_maps_from_sorted(
            t.polar, vals, tuple(self.cfg.image_size))
        return sensor_maps, hits, angular

    def _layers(self, states: WorldState):
        """The raster layers of S scenes: obstacles, robots (K1, one launch
        for every scene) and ped bodies and legs, each leg cloud shifted by
        its gait offset, then posed by the ped."""
        t, ct, p = self.tables, self.crowd, states.peds
        return raster.build_layers(
            states.obs_map, self.statics.resolution, states.robots.pose,
            t.robot_points, t.robot_mask,
            torch.cat([p.pos, p.yaw[..., None]], -1),
            ct.body_points, ct.body_mask,
            ct.left_points + p.leg_offset[..., 0:1, :], ct.left_mask,
            ct.right_points + p.leg_offset[..., 1:2, :], ct.right_mask)

    def _observe(self, state: WorldState) -> Tuple[WorldState, Observation]:
        new_state, obs = self.observe_scenes(_add_scene_axis(state))
        return _drop_scene_axis(new_state), map_tree(lambda x: x[0], obs)

    @trace.spanned("env.observe")
    def observe_scenes(self, states: WorldState
                       ) -> Tuple[WorldState, Observation]:
        """The observation of S scenes (every state tensor with a leading
        [S] axis; ``_observe_multi`` of the JAX package): one K1 launch for
        the raster of every scene, the sensor pass flat over the S*N robots,
        the ped observation flat (one K4 launch).  Observation fields are
        [S, N, ...]."""
        cfg = self.cfg
        t = self.tables
        r = states.robots
        p = states.peds
        ct = self.crowd
        s, n = r.pose.shape[:2]
        b = s * n
        dev = self.device
        with trace.span("env.raster"):
            layers = self._layers(states)
            collision = raster.collision_codes(layers, r.collision, r.arrive)
        poses = r.pose.reshape(b, 3)
        with trace.span("env.sensor"):
            sensor_maps, hits, angular = self._sensor_pass(layers.packed,
                                                           poses)

        vec = observe.vector_state(poses, r.goal.reshape(b, 2),
                                   r.goal_yaw.reshape(b),
                                   r.vw_last0.reshape(b, 2),
                                   int(cfg.state_dim))
        dist = observe.goal_distances(vec).reshape(s, n)
        step_ds = torch.where(states.has_prev_dist[:, None],
                              states.prev_goal_dist - dist,
                              torch.zeros_like(dist))
        lasers = observe.norm_lasers(hits, float(cfg.laser_max),
                                     cfg.laser_norm)
        # hit points: raw hit distances along the beam directions
        # (agent.cpp:434-436)
        hit_points = hits[..., None] * t.beam_dirs[None]
        if cfg.ped_sim.total:
            with trace.span("env.peds"):
                ped_vec, ped_map, ped_min = observe.ped_vectors_and_map(
                    r.pose, p.pos, p.vel, ct.ped_r, ct.robot_radius,
                    int(cfg.max_ped), int(cfg.ped_vec_dim),
                    int(cfg.ped_image_size[0]), float(cfg.ped_image_r))
        else:
            ped_vec = torch.zeros((s, n, 1 + cfg.ped_vec_dim * cfg.max_ped),
                                  device=dev)
            ped_map = torch.zeros((s, n, 3, cfg.ped_image_size[0],
                                   cfg.ped_image_size[1]), device=dev)
            ped_min = torch.full((s, n), float("inf"), device=dev)
        sh = lambda x: x.reshape((s, n) + x.shape[1:])
        obs = Observation(
            vector_states=sh(vec),
            sensor_maps=sh(sensor_maps),
            is_collisions=collision,
            is_arrives=r.arrive.to(torch.int32),
            lasers=sh(lasers),
            ped_vector_states=ped_vec,
            ped_maps=ped_map,
            step_ds=step_ds,
            ped_min_dists=ped_min,
            angular_maps=sh(angular),
            hit_points=sh(hit_points),
        )
        new_states = states._replace(
            robots=r._replace(collision=collision),
            prev_goal_dist=dist,
            has_prev_dist=torch.ones((s,), dtype=torch.bool, device=dev))
        return new_states, obs

    # ------------------------------------------------------------------
    def reset(self, sample: Optional[ScenarioSample] = None, carry=None,
              dataset=None):
        return self.reset_fn(sample, carry, dataset)

    def step(self, state, actions):
        return self.step_fn(state, torch.as_tensor(actions,
                                                   device=self.device))


def _add_scene_axis(state: WorldState) -> WorldState:
    return map_tree(lambda x: x[None], state)


def _drop_scene_axis(state: WorldState) -> WorldState:
    return map_tree(lambda x: x[0], state)
