"""Episode scenario sampling (torch port of ``img_env_tpu.env.sampler``;
EnvPos, reset_helper.py:104-345).

Every agent draws a fixed batch of candidate poses from the environment's
``torch.Generator`` on its device; validity is evaluated vectorized and the
first valid candidate wins.  Sequential clearance dependencies (each agent
must avoid the agents placed before it) are kept by placing agents in
order: >1 m between starts (and between goals), 2*module_size +
obstacle_radius against obstacles, and ``target_min_dist`` from the own
start for goals.  If any agent fails to place, the sample reports
``ok=False`` and ``sample_scenario_retry`` re-draws the whole scenario up
to ``reset_redraws`` times.

Pose types (reset_helper.py:189-300): ``fix`` and ``rand_angle`` assigned
up front; ``range`` boxes (4 or 6 elements, ``*_multi`` region lists
included); ``range_circle`` starts on a circle of radius
U(circle_ranges) around the region centre with N(0, 0.5^2) noise, the
goal diametrically opposite; ``..._circle_fix`` start angles spaced
-pi + (2pi/A) i; ``circle_fix`` goals exactly opposite, unchecked;
``range_view`` goals in the 8 m box around the start, outside its 5 m
box.  ``draw`` takes every random number of a scenario from the
generator and ``place`` turns them into poses, so tests can inject the
JAX sampler's draws.  ``SamplerSpec`` is a host-side numpy copy of the JAX
builder.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from navbench.reference.config import EnvConfig
from navbench.reference.ops import f32
from navbench.reference.ops.footprint import bounding_radius
from navbench.reference.ops.raster import transform_points

# pose-type codes
FIX = 0
RAND_ANGLE = 1
RANGE4 = 2
RANGE6 = 3
RANGE_CIRCLE = 4
RANGE_CIRCLE_FIX = 5
RANGE_VIEW = 6
CIRCLE_FIX = 7  # deterministic opposite (no 'range' prefix)

_VIEW_BOX = (2.5, 4.0, 2.5, 4.0)  # task_view (reset_helper.py:70)


def _encode_region(t: str, arr: np.ndarray) -> np.ndarray:
    p = np.zeros(6, np.float64)
    if "circle" in t:
        p[: min(2, arr.size)] = arr[:2]
    elif "view" in t:
        p[: min(4, arr.size)] = arr[:4]
    elif t == "fix" or t == "rand_angle":
        p[: min(6, arr.size)] = arr[:6]
    elif arr.size >= 6:
        p[:6] = arr[:6]
    else:
        p[:4] = arr[:4]
        p[4], p[5] = -3.14, 3.14
    return p


def _encode_type(t: str, params) -> Tuple[int, np.ndarray]:
    """-> (code, regions [R,6]).  ``*_multi`` pose types carry a LIST of
    candidate regions, one picked uniformly per attempt
    (reset_helper.py:239,274); every other type has exactly one region."""
    if "multi" in t and len(params) and isinstance(params[0], (list, tuple)):
        regions = np.stack([
            _encode_region(t, np.asarray(r, np.float64).reshape(-1))
            for r in params])
    else:
        regions = _encode_region(
            t, np.asarray(params, np.float64).reshape(-1))[None]
    if "circle" in t:
        if "fix" in t and "range" not in t:
            return CIRCLE_FIX, regions
        if "fix" in t:
            return RANGE_CIRCLE_FIX, regions
        return RANGE_CIRCLE, regions
    if "view" in t:
        return RANGE_VIEW, regions
    if t == "fix":
        return FIX, regions
    if t == "rand_angle":
        return RAND_ANGLE, regions
    first = params[0] if ("multi" in t and len(params)
                          and isinstance(params[0], (list, tuple))) else params
    if np.asarray(first, np.float64).reshape(-1).size >= 6:
        return RANGE6, regions
    return RANGE4, regions


class SamplerSpec(NamedTuple):
    """Static per-config sampling spec (host numpy, closed over by jit)."""

    # obstacles
    obs_shape_circle: np.ndarray   # [O] bool
    obs_size_range: np.ndarray     # [O,4]
    obs_type: np.ndarray           # [O] int (FIX or RANGE4/6)
    obs_params: np.ndarray         # [O,6]
    # agents (robots then peds)
    begin_type: np.ndarray         # [A]
    begin_params: np.ndarray       # [A,R,6] candidate regions per agent
    begin_nreg: np.ndarray         # [A] live region count (rest padded)
    target_type: np.ndarray        # [A]
    target_params: np.ndarray      # [A,R,6]
    target_nreg: np.ndarray        # [A]
    module_size: np.ndarray        # [A]
    n_robots: int
    n_peds: int
    circle_ranges: Tuple[float, float]
    target_min_dist: float
    go_back_mode: int              # 0 no, 1 yes, 2 random
    trials: int
    redraws: int                   # whole-scenario re-draws on ok=False

    @staticmethod
    def from_config(cfg: EnvConfig) -> "SamplerSpec":
        o = cfg.object.total
        obs_circle = np.zeros(o, bool)
        obs_sr = np.zeros((o, 4), np.float64)
        obs_t = np.zeros(o, np.int64)
        obs_p = np.zeros((o, 6), np.float64)
        for i in range(o):
            obs_circle[i] = cfg.object.shape[i] == "circle"
            sr = np.asarray(cfg.object.size_range[i], np.float64)
            obs_sr[i, : sr.size] = sr
            t = cfg.object.poses_type[i]
            pr = np.asarray(cfg.object.poses[i], np.float64)
            if t == "fix":
                obs_t[i] = FIX
                obs_p[i, : pr.size] = pr
            else:
                obs_t[i], obs_p[i] = _encode_type("range", pr)

        n, m = cfg.robot.total, cfg.ped_sim.total
        a = n + m
        bt = np.zeros(a, np.int64)
        tt = np.zeros(a, np.int64)
        mod = np.zeros(a, np.float64)
        b_regs, t_regs = [], []
        for i in range(a):
            if i < n:
                sh, sz = cfg.robot.shape[i], cfg.robot.size[i]
                b_t, b_p = cfg.robot.begin_poses_type[i], cfg.robot.begin_poses[i]
                g_t, g_p = cfg.robot.target_poses_type[i], cfg.robot.target_poses[i]
            else:
                j = i - n
                sh, sz = cfg.ped_sim.shape[j], cfg.ped_sim.size[j]
                b_t, b_p = cfg.ped_sim.begin_poses_type[j], cfg.ped_sim.begin_poses[j]
                g_t, g_p = cfg.ped_sim.target_poses_type[j], cfg.ped_sim.target_poses[j]
            mod[i] = bounding_radius(sh, sz)
            bt[i], br = _encode_type(b_t, b_p)
            tt[i], tr = _encode_type(g_t, g_p)
            b_regs.append(br)
            t_regs.append(tr)
        rmax = max([r.shape[0] for r in b_regs + t_regs] or [1])
        bp = np.zeros((a, rmax, 6), np.float64)
        tp = np.zeros((a, rmax, 6), np.float64)
        bn = np.ones(a, np.int64)
        tn = np.ones(a, np.int64)
        for i in range(a):
            bn[i] = b_regs[i].shape[0]
            bp[i, : bn[i]] = b_regs[i]
            bp[i, bn[i]:] = b_regs[i][-1]       # pad with last (never drawn)
            tn[i] = t_regs[i].shape[0]
            tp[i, : tn[i]] = t_regs[i]
            tp[i, tn[i]:] = t_regs[i][-1]
        gb = {"no": 0, "yes": 1, "random": 2}[cfg.ped_sim.go_back]
        return SamplerSpec(
            obs_shape_circle=obs_circle, obs_size_range=obs_sr,
            obs_type=obs_t, obs_params=obs_p,
            begin_type=bt, begin_params=bp, begin_nreg=bn,
            target_type=tt, target_params=tp, target_nreg=tn,
            module_size=mod, n_robots=n, n_peds=m,
            circle_ranges=tuple(cfg.circle_ranges),
            target_min_dist=float(cfg.target_min_dist),
            go_back_mode=gb, trials=int(cfg.reset_trials),
            redraws=int(cfg.reset_redraws),
        )


class ScenarioSample(NamedTuple):
    obs_pose: torch.Tensor      # [O,3]
    obs_radius: torch.Tensor    # [O] clearance radius (circle r or rect diag)
    obs_circle_r: torch.Tensor  # [O] sampled circle radius (rects: 0)
    init_poses: torch.Tensor    # [A,3] robots then peds
    target_poses: torch.Tensor  # [A,3]
    go_back: torch.Tensor       # [M] bool
    ok: torch.Tensor            # [] bool all agents placed cleanly


class SamplerDraws(NamedTuple):
    """Every random number one scenario reads (T = ``spec.trials``)."""

    obs_u: torch.Tensor          # [O,4] uniform: x, y, yaw, circle radius
    pre_u: torch.Tensor          # [A] uniform: rand_angle yaws
    begin_u: torch.Tensor        # [A,T,3] uniform per start proposal
    begin_region: torch.Tensor   # [A,T] int64 region of each proposal
    target_u: torch.Tensor       # [A,T,3]
    target_region: torch.Tensor  # [A,T]
    circle_range: torch.Tensor   # [] radius of the circle pose types
    begin_gauss: torch.Tensor    # [A,T,2] N(0, 0.5^2) circle start noise
    target_gauss: torch.Tensor   # [A,T,2] N(0, 0.5^2) circle goal noise
    go_back_u: torch.Tensor      # [M] uniform (go_back 'random')


_CIRCLES = (RANGE_CIRCLE, RANGE_CIRCLE_FIX, CIRCLE_FIX)


def draw(spec: SamplerSpec, generator: torch.Generator,
         device=None) -> SamplerDraws:
    """The draws of one scenario from ``generator``, float32, on
    ``device`` (default: the generator's).  The circle radius and noises
    are drawn only when a circle pose type is configured (zeros
    otherwise), the go-back draw only for 'random'."""
    dt = torch.float32
    device = generator.device if device is None else device
    o, a, t, m = (spec.obs_type.shape[0], spec.begin_type.shape[0],
                  spec.trials, spec.n_peds)
    rand = lambda *shape: torch.rand(shape, generator=generator,
                                     device=device, dtype=dt)

    def regions(nreg):
        r = torch.floor(rand(a, t) * torch.as_tensor(
            nreg, dtype=dt, device=device)[:, None]).to(torch.int64)
        return torch.minimum(r, torch.as_tensor(nreg - 1,
                                                device=device)[:, None])

    obs_u = rand(o, 4) if o else torch.zeros((0, 4), dtype=dt, device=device)
    pre_u = rand(a)
    begin_u, begin_region = rand(a, t, 3), regions(spec.begin_nreg)
    target_u, target_region = rand(a, t, 3), regions(spec.target_nreg)
    codes = np.concatenate([spec.begin_type, spec.target_type])
    if np.isin(codes, _CIRCLES).any():
        lo, hi = spec.circle_ranges
        circle_range = lo + rand() * (hi - lo)
        gauss = lambda: torch.randn((a, t, 2), generator=generator,
                                    device=device, dtype=dt) * 0.5
        begin_gauss, target_gauss = gauss(), gauss()
    else:
        circle_range = torch.zeros((), dtype=dt, device=device)
        begin_gauss = target_gauss = torch.zeros((a, t, 2), dtype=dt,
                                                 device=device)
    go_back_u = (rand(m) if spec.go_back_mode == 2
                 else torch.zeros((m,), dtype=dt, device=device))
    return SamplerDraws(obs_u, pre_u, begin_u, begin_region, target_u,
                        target_region, circle_range, begin_gauss,
                        target_gauss, go_back_u)


def _circle(radius, angle, p, yaw, gauss=None):
    """Poses on the circle of ``radius`` around the region's (x, y) at
    ``angle``, facing ``yaw``.  In float32 the bits are the JAX package's
    CPU build's: glibc's sin/cos, and each coordinate one fused
    multiply-add, as XLA contracts ``r * cos(a) + px`` (ops/f32.py)."""
    sin, cos = f32.sin_cos(angle)
    r = torch.as_tensor(radius, dtype=angle.dtype,
                        device=angle.device).expand_as(angle)
    x = f32.fma(r, cos, p[..., 0])
    y = f32.fma(r, sin, p[..., 1])
    if gauss is not None:
        x, y = x + gauss[..., 0], y + gauss[..., 1]
    return torch.stack([x, y, yaw], -1)


def _lerp(lo, u, span):
    """``lo + u * span`` as XLA contracts it: one fused multiply-add."""
    lo, u, span = torch.broadcast_tensors(torch.as_tensor(lo, dtype=u.dtype,
                                                          device=u.device),
                                          u, torch.as_tensor(
                                              span, dtype=u.dtype,
                                              device=u.device))
    return f32.fma(u, span, lo)


def _yaw(u):
    """A uniform yaw in [-3.14, 3.14)."""
    return _lerp(-3.14, u, 6.28)


def _view(init, u):
    """range_view: uniform over the 8 m box around ``init`` [..., 3]."""
    b = _VIEW_BOX[1]
    return torch.stack([_lerp(init[..., 0] - b, u[..., 0], 2 * b),
                        _lerp(init[..., 1] - b, u[..., 1], 2 * b),
                        _yaw(u[..., 2])], -1)


def _box(u, p):
    """range: uniform in the region's box (x, y, yaw).  XLA contracts the
    x and y of an agent's proposal, not its yaw."""
    return torch.stack([_lerp(p[..., 0], u[..., 0], p[..., 1] - p[..., 0]),
                        _lerp(p[..., 2], u[..., 1], p[..., 3] - p[..., 2]),
                        p[..., 4] + u[..., 2] * (p[..., 5] - p[..., 4])], -1)


def _begin_candidates(code, u, gauss, p, circle_range, n_agents: int):
    """Start proposals [A,T,3] of every agent (reset_helper.py:189-300).
    A start is drawn only for an agent not yet placed, whose pose is
    still 0, so the pose-relative types read a zero pose here, as the JAX
    sampler's do."""
    dev = u.device
    out = _box(u, p)
    zero = torch.zeros_like(u[..., 0])
    step = torch.arange(n_agents, device=dev, dtype=u.dtype)[:, None] + zero
    kinds = {
        # the start faces away from the centre: angle + 3.14, which XLA
        # folds to the uniform's product alone (-3.14 + 3.14 is 0)
        RANGE_CIRCLE: lambda: _circle(circle_range, _yaw(u[..., 0]), p,
                                      u[..., 0] * 6.28, gauss),
        RANGE_CIRCLE_FIX: lambda: _circle(
            circle_range, _lerp(-3.14, step, 6.28 / n_agents), p,
            step * (6.28 / n_agents), gauss),
        RANGE_VIEW: lambda: _view(torch.zeros_like(u), u),
        CIRCLE_FIX: lambda: _circle(circle_range, zero, p, zero - 3.14),
    }
    for k, make in kinds.items():
        if (code == k).any():
            sel = torch.as_tensor(code == k, device=dev)[:, None, None]
            out = torch.where(sel, make(), out)
    return out


def _first_valid(cands, valid):
    """(first valid candidate [3], any valid [])."""
    pick = valid.to(torch.uint8).argmax().reshape(1)
    return cands.index_select(0, pick)[0], valid.any()


def place(spec: SamplerSpec, d: SamplerDraws) -> ScenarioSample:
    """The scenario that the draws ``d`` give (the JAX package's
    ``sample_scenario`` after its draws)."""
    dev = d.pre_u.device
    dtype = d.pre_u.dtype
    o = spec.obs_type.shape[0]
    a = spec.begin_type.shape[0]
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    # ---- obstacles (no clearance checks, reset_helper.py:122-165) ----
    if o > 0:
        u = d.obs_u
        sr = f(spec.obs_size_range)
        circ_r = _lerp(sr[:, 0], u[:, 3], sr[:, 1] - sr[:, 0])
        rect_r = f32.sqrt(sr[:, 0] ** 2 + sr[:, 2] ** 2)
        is_circ = torch.as_tensor(spec.obs_shape_circle, device=dev)
        p = f(spec.obs_params)
        drawn = torch.stack(
            [_lerp(p[:, 2 * k], u[:, k], p[:, 2 * k + 1] - p[:, 2 * k])
             for k in range(3)], -1)
        is_fix = torch.as_tensor(spec.obs_type == FIX, device=dev)
        obs_pose = torch.where(is_fix[:, None], p[:, :3], drawn)
        obs_radius = torch.where(is_circ, circ_r, rect_r)
        obs_circle_r = torch.where(is_circ, circ_r, torch.zeros_like(circ_r))
    else:
        obs_pose = torch.zeros((0, 3), dtype=dtype, device=dev)
        obs_radius = torch.zeros((0,), dtype=dtype, device=dev)
        obs_circle_r = torch.zeros((0,), dtype=dtype, device=dev)

    # ---- fixed / rand_angle poses, assigned up front ----
    bt, tt = spec.begin_type, spec.target_type
    bp, tp = f(spec.begin_params), f(spec.target_params)

    def prefill(code, params):
        p0 = params[:, 0]
        ra = torch.stack([p0[:, 0], p0[:, 1],
                          _lerp(p0[:, 2], d.pre_u, p0[:, 3] - p0[:, 2])], -1)
        poses = torch.zeros((a, 3), dtype=dtype, device=dev)
        poses = torch.where(torch.as_tensor(code == FIX, device=dev)[:, None],
                            p0[:, :3], poses)
        poses = torch.where(
            torch.as_tensor(code == RAND_ANGLE, device=dev)[:, None],
            ra, poses)
        return poses, (code == FIX) | (code == RAND_ANGLE)

    init_poses, need_b = prefill(bt, bp)
    target_poses, need_t = prefill(tt, tp)
    need_b, need_t = ~need_b, ~need_t

    # ---- proposals, then sequential placement ----
    pick = lambda params, r: torch.gather(params, 1,
                                          r[..., None].expand(-1, -1, 6))
    p_b, p_t = pick(bp, d.begin_region), pick(tp, d.target_region)
    cr = d.circle_range
    cand_b = _begin_candidates(bt, d.begin_u, d.begin_gauss, p_b, cr, a)
    cand_t = _box(d.target_u, p_t)
    init_filled = torch.as_tensor(~need_b, device=dev)
    target_filled = torch.as_tensor(~need_t, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    tmd2 = spec.target_min_dist ** 2
    for i in range(a):
        mod = float(spec.module_size[i])
        if need_b[i]:
            valid = (_clear_of_agents(cand_b[i, :, :2], init_poses,
                                      init_filled)
                     & _clear_of_obstacles(cand_b[i, :, :2], mod, obs_pose,
                                           obs_radius))
            pose, got = _first_valid(cand_b[i], valid)
            init_poses[i] = pose
            ok = ok & got
        init_filled[i] = True
        if need_t[i]:
            # goals of the pose-relative types derive from the start
            init, code = init_poses[i], int(tt[i])
            tc = cand_t[i]
            if code in (RANGE_CIRCLE, RANGE_CIRCLE_FIX):
                yaw = init[2].expand(tc.shape[0])
                tc = _circle(cr, yaw, p_t[i], yaw - 3.14, d.target_gauss[i])
            elif code == CIRCLE_FIX:
                yaw = init[2].expand(tc.shape[0])
                tc = _circle(cr, yaw, p_t[i], yaw - 3.14)
            elif code == RANGE_VIEW:
                tc = _view(init, d.target_u[i])
            if code == CIRCLE_FIX:
                # the deterministic opposite skips every check
                # (reset_helper.py:260-265)
                tvalid = torch.ones(tc.shape[0], dtype=torch.bool, device=dev)
            else:
                tvalid = ((((tc[:, :2] - init[:2]) ** 2).sum(-1) > tmd2)
                          & _clear_of_agents(tc[:, :2], target_poses,
                                             target_filled)
                          & _clear_of_obstacles(tc[:, :2], mod, obs_pose,
                                                obs_radius))
            if code == RANGE_VIEW:
                # outside the +-2.5 m box around the start, inside the
                # drawn region
                pv = p_t[i]
                bx, by = _VIEW_BOX[0], _VIEW_BOX[2]
                inner = ((tc[:, 0] >= init[0] - bx)
                         & (tc[:, 0] <= init[0] + bx)
                         & (tc[:, 1] >= init[1] - by)
                         & (tc[:, 1] <= init[1] + by))
                tvalid = tvalid & ~inner & (
                    (tc[:, 0] >= pv[:, 0]) & (tc[:, 0] <= pv[:, 1])
                    & (tc[:, 1] >= pv[:, 2]) & (tc[:, 1] <= pv[:, 3]))
            pose, got = _first_valid(tc, tvalid)
            target_poses[i] = pose
            ok = ok & got
        target_filled[i] = True

    m = spec.n_peds
    if spec.go_back_mode == 1:
        go_back = torch.ones((m,), dtype=torch.bool, device=dev)
    elif spec.go_back_mode == 0:
        go_back = torch.zeros((m,), dtype=torch.bool, device=dev)
    else:
        go_back = d.go_back_u > 0.5
    return ScenarioSample(
        obs_pose=obs_pose, obs_radius=obs_radius, obs_circle_r=obs_circle_r,
        init_poses=init_poses, target_poses=target_poses, go_back=go_back,
        ok=ok)


def _clear_of_agents(cand_xy, poses, filled):
    d = torch.sqrt(((cand_xy[:, None, :] - poses[None, :, :2]) ** 2).sum(-1))
    return ~((d <= 1.0) & filled[None, :]).any(dim=1)


def _clear_of_obstacles(cand_xy, module: float, obs_pose, obs_radius):
    d = torch.sqrt(((cand_xy[:, None, :] - obs_pose[None, :, :2]) ** 2
                    ).sum(-1))
    thresh = 2.0 * module + obs_radius[None, :]
    return ~((d <= thresh) & (obs_radius[None, :] != 0.0)).any(dim=1)


def sample_scenario(spec: SamplerSpec, generator: torch.Generator,
                    device=None) -> ScenarioSample:
    """One scenario on ``device`` (default: the generator's)."""
    return place(spec, draw(spec, generator, device))


def sample_scenario_retry(spec: SamplerSpec, generator: torch.Generator,
                          device=None) -> ScenarioSample:
    """Bounded whole-scenario re-draw when placement fails (ok=False),
    as the reference re-rolls layouts (reset_helper.py:251-258) and
    retries reset up to 10 times (yaml_env.py:304-311)."""
    s = sample_scenario(spec, generator, device)
    for _ in range(max(spec.redraws, 0)):
        if bool(s.ok):
            break
        s = sample_scenario(spec, generator, device)
    return s


def obstacle_corners(obs_pose, spec: SamplerSpec, obs_circle_r):
    """World-frame (pax,pay,pbx,pby) per obstacle — Agent::get_corners
    (agent.cpp:626-651), with the pose rotation applied (no AABB min/max)."""
    sr = torch.as_tensor(spec.obs_size_range, dtype=obs_pose.dtype,
                         device=obs_pose.device)
    is_circ = torch.as_tensor(spec.obs_shape_circle,
                              device=obs_pose.device)[:, None]
    r = obs_circle_r
    pa_base = torch.where(is_circ, torch.stack([-r, -r], -1),
                          torch.stack([sr[:, 0], sr[:, 2]], -1))
    pb_base = torch.where(is_circ, torch.stack([r, r], -1),
                          torch.stack([sr[:, 1], sr[:, 3]], -1))
    # the rotation with the JAX package's float32 bits (ops/raster.py)
    rot = lambda p: transform_points(obs_pose, p[:, None])[:, 0]
    return torch.cat([rot(pa_base), rot(pb_base)], -1)
