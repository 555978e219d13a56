"""The port's scene batch (``img_env_tpu_torch.parallel.BatchedNavEnv``)
against the JAX package's, on ``tests/test_multiscene_flat.py``'s configs:
S=4 scenes of 2 robots, 3 rectangles and 0 or 2 leg peds in ``room_10.png``,
3 m views at 0.05 m, 64 beams.

Both packages run in float32 (the JAX side jitted under
``jax.enable_x64(False)``); on the CPU the port runs its kernels' twins.
The JAX samples are injected (torch cannot reproduce threefry draws), and
every step starts from the JAX states (teacher forcing), as
``test_torch_env.py`` does: the port's own step gives the JAX robot states
bit for bit and the crowd within its stated tolerances (F15, F16), and
the port's observation of the JAX states after the crowd and robot
dynamics is bit-exact on every surface.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img_env_tpu.config import EnvConfig as JaxEnvConfig
from img_env_tpu.env.sampler import sample_scenario_retry
from img_env_tpu.parallel.batched_env import BatchedNavEnv as JaxBatchedNavEnv
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.core.convert import world_state_from_numpy
from img_env_tpu_torch.core.state import map_tree, stack_trees
from img_env_tpu_torch.crowd import orca, sfm
from img_env_tpu_torch.crowd.obstacle_split import split_segments
from img_env_tpu_torch.env.sampler import ScenarioSample
from img_env_tpu_torch.mpc.prediction import predict_orca
from img_env_tpu_torch.parallel import BatchedNavEnv
from tests.test_multiscene_flat import OBS_FIELDS
from tests.test_torch_env import _assert_vector_states

S = 4
STEPS = 3
CASES = [(2, "pedscene", True), (2, "rvoscene", True), (0, "", True),
         (2, "pedscene", False)]
ACTS = np.tile(np.asarray([[0.4, 0.3, 0.0], [0.5, -0.2, 0.0]], np.float32),
               (S, 1, 1))
# crowd floats (pos, vel): SFM within float32 rounding, except the first
# step's velocities, whose theta-sign term starts from rest (F15: the
# direction of a near-zero angle is rounding noise, so a velocity can flip
# its social-force component; the positions agree); float32 ORCA's LP
# conditioning (F16)
CROWD_TOL = {"pedscene": (1e-5, 1e-5), "rvoscene": (1e-3, 2e-3)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def cfg_dict(peds=2, scene="pedscene", use_laser=True):
    """``tests/test_multiscene_flat.py``'s config."""
    box = [[1.0, 9.0, 1.0, 9.0]]
    d = {
        "robot": {"total": 2, "begin_poses_type": ["range"],
                  "begin_poses": box, "target_poses_type": ["range"],
                  "target_poses": box},
        "object": {"total": 3, "shape": ["rectangle"],
                   "size_range": [[0.1, 0.4, 0.1, 0.4]],
                   "poses_type": ["range"], "poses": [[2.0, 8.0, 2.0, 8.0]]},
        "ped_sim": {"total": peds, "type": scene, "max_speed": [0.5],
                    "shape": ["leg"], "size": [[0.0, 0.1, 0.1]],
                    "begin_poses_type": ["range"], "begin_poses": box,
                    "target_poses_type": ["range"], "target_poses": box},
        "global_map": {"resolution": 0.1, "map_file": "room_10.png"},
        "view_map": {"resolution": 0.05, "width": 3, "height": 3},
        "range_total": 64,
        "max_ped": 3,
        "use_laser": use_laser,
        "sensor_mode": "parity",
    }
    if peds == 0:
        d["ped_sim"] = {"total": 0, "type": ""}
    return d


def port_cfg(args):
    return EnvConfig.from_dict(cfg_dict(*args))


_SAMPLERS = {}


def _vmapped_sampler(spec):
    """One jitted sampler per distinct spec (the crowd type and the lasers
    leave it as it is, so most configs here share one program)."""
    leaves, tree = jax.tree_util.tree_flatten(spec)
    key = (str(tree),) + tuple((np.asarray(x).dtype.str, np.asarray(x).shape,
                                np.asarray(x).tobytes()) for x in leaves)
    if key not in _SAMPLERS:
        _SAMPLERS[key] = jax.jit(jax.vmap(lambda k: sample_scenario_retry(
            jax.random.split(k)[0], spec)))
    return _SAMPLERS[key]


def jax_samples(env_j, keys):
    """The JAX batch reset's scenario per scene key (nav_env.reset_state_fn),
    drawn under vmap as the batch reset draws them: XLA contracts the
    sampler's multiply-adds differently in a program of its own."""
    with jax.enable_x64(False):
        out = _vmapped_sampler(env_j.core.statics.sampler)(keys)
    return [ScenarioSample(*(torch.as_tensor(np.array(x[k])) for x in out))
            for k in range(keys.shape[0])]


def assert_obs_exact(got, want, fields=OBS_FIELDS):
    """Every surface bit-exact; the vector states' relative yaw within an
    ulp (glibc's atan2f, F17; tests/test_torch_env.py)."""
    for f in fields:
        g = np.asarray(getattr(got, f))
        if f == "vector_states":
            w = np.asarray(getattr(want, f))
            assert g.shape == w.shape
            _assert_vector_states(g.reshape(-1, g.shape[-1]),
                                  w.reshape(-1, w.shape[-1]))
            continue
        w = np.asarray(getattr(want, f))
        assert g.shape == w.shape, (f, g.shape, w.shape)
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=f)


class Pair:
    """The JAX batch (jitted entry points, and its advance and flat
    observation as separate programs for teacher forcing) and the port's
    batch on the CPU."""

    def __init__(self, args):
        with jax.enable_x64(False):
            self.j = JaxBatchedNavEnv(JaxEnvConfig.from_dict(cfg_dict(*args)),
                                      mesh=None)
            core = self.j.core
            self.advance = jax.jit(jax.vmap(core.advance_fn))
            self.observe = jax.jit(
                lambda s: core._observe_multi(s, core.sensor_tables))
        self.t = BatchedNavEnv(port_cfg(args), "cpu")

    def reset(self, keys, carry=None, **kw):
        with jax.enable_x64(False):
            states, obs = self.j.reset(keys, carry=carry, **kw)
        got = self.t.reset(jax_samples(self.j, keys),
                           carry=None if carry is None
                           else world_state_from_numpy(_np(carry)),
                           **{k: torch.as_tensor(np.asarray(v))
                              for k, v in kw.items()})
        return states, obs, got


@functools.lru_cache(maxsize=None)
def _pair(args):
    """One Pair per config, shared by this module's tests."""
    return Pair(args)


@pytest.fixture(params=CASES,
                ids=["pedscene", "rvoscene", "none", "pedscene-nolaser"])
def pair(request):
    return request.param, _pair(request.param)


def test_batch_matches_jax_through_steps_and_carried_reset(pair):
    args, p = pair
    scene = args[1]
    states_j, obs_j, (states_t, obs_t) = p.reset(
        jax.random.split(jax.random.PRNGKey(3), S))
    assert_obs_exact(obs_t, obs_j)
    for f in ("pose", "goal", "goal_yaw"):
        np.testing.assert_array_equal(getattr(states_t.robots, f).numpy(),
                                      np.asarray(getattr(states_j.robots, f)))
    np.testing.assert_array_equal(states_t.obs_map.numpy(),
                                  np.asarray(states_j.obs_map))
    for step in range(STEPS):
        state_in = world_state_from_numpy(_np(states_j))
        with jax.enable_x64(False):
            # the JAX batch step is this advance, then this observation
            adv_j, _, _ = p.advance(states_j, jnp.asarray(ACTS))
            states_j, obs_j = p.observe(adv_j)
        coll = np.asarray(obs_j.is_collisions)
        arr = np.asarray(obs_j.is_arrives)
        rew_j = (arr - coll).astype(np.float32)
        done_j = np.clip(np.clip(coll, -1, 1) + arr, 0, 1)
        # the port's own step from the same JAX states
        st_t, obs_t, rew_t, done_t, info = p.t.step(
            state_in, torch.as_tensor(ACTS))
        for f in ("pose", "vw_last0", "vw_last1", "vel_world", "arrive"):
            np.testing.assert_array_equal(
                getattr(st_t.robots, f).numpy(),
                np.asarray(getattr(states_j.robots, f)), err_msg=f)
        if scene:
            pos_tol, vel_tol = CROWD_TOL[scene]
            np.testing.assert_allclose(st_t.peds.pos.numpy(),
                                       np.asarray(states_j.peds.pos),
                                       rtol=0, atol=pos_tol)
            if step or scene != "pedscene":
                np.testing.assert_allclose(st_t.peds.vel.numpy(),
                                           np.asarray(states_j.peds.vel),
                                           rtol=0, atol=vel_tol)
        np.testing.assert_array_equal(rew_t.numpy(), np.asarray(rew_j))
        np.testing.assert_array_equal(done_t.numpy(), np.asarray(done_j))
        np.testing.assert_array_equal(info["beeps"].numpy(), 0)
        # the port's observation of the JAX states
        _, obs_f = p.t.core.observe_scenes(world_state_from_numpy(_np(adv_j)))
        assert_obs_exact(obs_f, obs_j)
    # carried re-reset (auto-reset): vw_last1, the gait and the crowd
    # velocities persist
    states2_j, obs2_j, (states2_t, obs2_t) = p.reset(
        jax.random.split(jax.random.PRNGKey(9), S), carry=states_j)
    assert_obs_exact(obs2_t, obs2_j)
    for f in ("vw_last0", "vw_last1"):
        np.testing.assert_array_equal(getattr(states2_t.robots, f).numpy(),
                                      np.asarray(getattr(states2_j.robots, f)))
    for f in states2_t.peds._fields:
        np.testing.assert_array_equal(getattr(states2_t.peds, f).numpy(),
                                      np.asarray(getattr(states2_j.peds, f)),
                                      err_msg=f)


# ----------------------------------------------------------------------
# The crowd of S scenes stepped at once against the same scenes stepped
# one at a time (S=1), in torch alone.  Every crowd operation is
# elementwise per scene or reduces an axis (the 2 coordinates, the
# scene's agents, its segments) of the same length in the same order, so
# the batch is bit-equal to S=1 calls wherever each element is computed
# alike: on the card (tests/test_torch_cuda_kernels.py holds that), and
# here for the unbatched call against S=1 (the same sizes).  Torch's CPU
# kernel evaluates atan2 with a SIMD polynomial in the body of its loop
# and with libm in its tail (they differ in the last bit for ~16% of
# arguments), so an element's bits depend on its place in the tensor,
# and a tensor of 3 scenes places it elsewhere than one of 1: the floats
# of the batched env step are held to the pedscene crowd tolerance
# (CROWD_TOL, 1e-5), integers and flags exactly.

BATCH_STEPS = 4


def _leaves(tree):
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return [x for part in tree for x in _leaves(part)]
    out = []
    map_tree(out.append, tree)
    return out


def _assert_bits(got, want, what):
    for k, (g, w) in enumerate(zip(_leaves(got), _leaves(want))):
        assert g.dtype == w.dtype and torch.equal(g, w), (what, k)


def _assert_crowd_close(got, want, what):
    for k, (g, w) in enumerate(zip(_leaves(got), _leaves(want))):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        if g.is_floating_point():
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=CROWD_TOL["pedscene"][0],
                                       err_msg=f"{what}, leaf {k}")
        else:
            assert torch.equal(g, w), (what, k)


def _steps_match_scene_by_scene(benv, states):
    """BATCH_STEPS batch steps against each scene's own S=1 steps from the
    same start: peds, crowd velocities and robots."""
    s = states.step.shape[0]
    g = torch.Generator().manual_seed(17)
    one = [map_tree(lambda x, k=k: x[k:k + 1], states) for k in range(s)]
    for t in range(BATCH_STEPS):
        acts = torch.as_tensor(ACTS[:s]) * (1.0 + 0.5 * t)
        beep_u = torch.rand((s, acts.shape[1]), generator=g)
        states = benv.step(states, acts, beep_u)[0]
        one = [benv.step(x, acts[k:k + 1], beep_u[k:k + 1])[0]
               for k, x in enumerate(one)]
        want = stack_trees([map_tree(lambda x: x[0], x) for x in one])
        for part in ("peds", "crowd_aux", "robots"):
            _assert_crowd_close(getattr(states, part), getattr(want, part),
                                f"{part} at step {t}")
    return states


def _pedscene_batch():
    """Three pedscene scenes that differ in every part of the crowd's
    bookkeeping: scene 0's peds head-on (the look-ahead force); scene 1's
    at rest, one needing a fetch from a wrapped head, on its second
    trajectory slot; scene 2's first ped on its goal (the r=1 arrival),
    its second on a trajectory waypoint, its robots done (one arrived,
    one collided) with crowd velocities left."""
    benv = BatchedNavEnv(port_cfg((2, "pedscene", True)), "cpu", seed=11)
    states, _ = benv.reset(3)
    p, r = states.peds, states.robots
    at_rest = torch.tensor([1.0, 0.0, 1.0])[:, None, None]
    pos, goal, vel = p.pos.clone(), p.goal.clone(), p.vel + 0.2 * at_rest
    pos[0] = torch.tensor([[3.0, 5.0], [5.0, 5.1]])
    goal[0] = torch.tensor([[8.0, 5.0], [1.5, 5.1]])
    vel[0] = torch.tensor([[0.4, 0.0], [-0.4, 0.0]])
    pos[2, 0] = goal[2, 0] + 0.3
    peds = p._replace(
        pos=pos, goal=goal, vel=vel,
        sfm_has_dest=torch.tensor([[True, True], [False, True],
                                   [True, True]]),
        sfm_lastdest=torch.tensor([[-1, -1], [5, -1], [-1, 1]],
                                  dtype=torch.int32),
        sfm_wp_idx=torch.tensor([[0, 0], [0, 0], [0, 2]], dtype=torch.int32),
        traj_idx=torch.tensor([[0, 0], [1, 0], [0, 1]], dtype=torch.int32),
        gait_state=torch.tensor([[0, 3], [6, 1], [4, 5]], dtype=torch.int32))
    robots = r._replace(
        arrive=torch.tensor([[False, False], [False, False], [True, False]]),
        collision=torch.tensor([[0, 0], [0, 0], [0, 1]], dtype=torch.int32))
    aux = states.crowd_aux._replace(
        robot_vel=torch.linspace(-0.3, 0.4, 12).reshape(3, 2, 2))
    return benv, states._replace(peds=peds, robots=robots, crowd_aux=aux)


def _dataset_batch():
    """Three replayed scenes, each with its own series (lengths that end
    before, at and after the steps taken) and its own step index."""
    benv = BatchedNavEnv(port_cfg((2, "dataset", True)), "cpu", seed=12)
    core = benv.core
    g = torch.Generator().manual_seed(3)
    parts = []
    for k, lens in enumerate(([7, 3], [2, 7], [5, 7])):
        traj = 2.0 + 6.0 * torch.rand((2, 7, 2), generator=g)
        vel = torch.rand((2, 7, 2), generator=g) - 0.5
        parts.append(core.reset_state_fn(
            core.sample_scenario(), None,
            (traj, vel, torch.tensor(lens, dtype=torch.int32))))
    states, _ = core.observe_scenes(stack_trees(parts))
    return benv, states._replace(
        step=torch.tensor([0, 2, 5], dtype=torch.int32))


def _sfm_population(a=7, o=4, seed=5):
    g = torch.Generator().manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=g)
    wp_len = torch.tensor([2, 3, 1, 2, 0, 0, 3], dtype=torch.int32)[:a]
    wp = sfm.SfmWaypointState(
        wp_xy=1.0 + 8.0 * u(a, 3, 2), wp_r=(u(a, 3) < 0.5).float(),
        wp_len=wp_len,
        dest_idx=torch.tensor([0, 2, 0, 1, 0, 0, 1], dtype=torch.int32)[:a],
        head=torch.tensor([-1, 4, 0, 1, 0, 0, 2], dtype=torch.int32)[:a],
        has_dest=torch.tensor([True, False, True, False, False, False,
                               True])[:a])
    seg_a = 2.0 + 6.0 * u(o, 2)
    return (2.0 + 6.0 * u(a, 2), u(a, 2) - 0.5, 0.4 + 0.8 * u(a),
            torch.tensor([True] * (a - 1) + [False]), wp, seg_a,
            seg_a + u(o, 2) - 0.5, torch.tensor([True, False, True, True]))


def _check_sfm_unbatched():
    """The MPC 'sfm' head's unbatched call [A, ...] against the S=1 call."""
    pos, vel, vmax, valid, wp, seg_a, seg_b, seg_valid = _sfm_population()
    one = lambda x: x[None]
    bpos, bvel, bwp = one(pos), one(vel), map_tree(one, wp)
    for t in range(BATCH_STEPS):
        pos, vel, wp = sfm.sfm_step(pos, vel, vmax, valid, wp, seg_a, seg_b,
                                    seg_valid, 0.4)
        bpos, bvel, bwp = sfm.sfm_step(
            bpos, bvel, one(vmax), one(valid), bwp, one(seg_a), one(seg_b),
            one(seg_valid), 0.4)
        _assert_bits((bpos[0], bvel[0]), (pos, vel), f"step {t}")
        _assert_bits(map_tree(lambda x: x[0], bwp), wp, f"queue {t}")
    assert not torch.equal(pos, _sfm_population()[0])


# rectangles whose kd-tree splits leave 12, 16 and 20 segments
ORCA_BOXES = torch.tensor([
    [[2.0, 2.0, 2.6, 2.4], [5.0, 6.0, 5.4, 6.3], [7.0, 3.0, 7.3, 3.5]],
    [[2.0, 4.0, 6.0, 4.3], [3.0, 2.0, 3.3, 6.0], [6.5, 6.5, 7.0, 7.0]],
    [[3.0, 3.0, 3.4, 7.0], [2.0, 5.0, 6.0, 5.3], [4.5, 2.0, 4.8, 6.5]]])


def _orca_batch(scene):
    """Three ORCA scenes of 3 peds and 2 robot mirrors, each on its own
    split (12, 16 and 20 segments): scene 0's first two peds and a robot
    within each other's ORCA radius (the collision lines), scene 1's
    peds between crossing walls, scene 2's peds at rest by a beeping
    robot.  The third ped is invalid in every scene.  Beeps ([S, N, 2],
    [S, N]): every scene's first robot answered, scene 1's second too
    (``ervoscene`` alone reads them)."""
    benv = BatchedNavEnv(port_cfg((3, scene, True)), "cpu", seed=13)
    core = benv.core
    core.crowd = core.crowd._replace(sfm_valid=torch.tensor(
        [True, True, False, True, True]))
    states, _ = benv.reset(3)
    p, r = states.peds, states.robots
    pos, vel = p.pos.clone(), p.vel.clone()
    pos[0, :2] = torch.tensor([[4.0, 4.5], [4.3, 4.55]])
    vel[0, :2] = torch.tensor([[0.4, 0.0], [-0.4, 0.1]])
    pos[1] = torch.tensor([[3.6, 4.6], [2.6, 3.7], [5.0, 5.0]])
    vel[1] = torch.tensor([[-0.3, -0.3], [0.2, 0.1], [0.0, 0.0]])
    pos[2] = torch.tensor([[6.0, 2.5], [6.4, 2.9], [7.0, 8.0]])
    vel[2] = 0.0
    pose = r.pose.clone()
    pose[0, 0, :2] = torch.tensor([4.15, 4.9])
    pose[2, 0, :2] = torch.tensor([6.3, 2.2])
    segs = [split_segments(b, torch.ones(3, dtype=torch.bool))[0]
            for b in ORCA_BOXES]
    obstacles = states.obstacles._replace(
        aabb=ORCA_BOXES.clone(), segs=stack_trees(segs))
    states = states._replace(peds=p._replace(pos=pos, vel=vel),
                             robots=r._replace(pose=pose),
                             obstacles=obstacles)
    radii = torch.tensor([[1.0, 0.0], [1.0, 1.0], [1.0, 0.0]])
    sources = torch.where(radii[..., None] > 0, pose[..., :2], 0.0)
    return benv, states, sources, radii


def _orca_steps_match_scene_by_scene(scene):
    """BATCH_STEPS crowd steps (``NavEnv._crowd_step``) of the three
    scenes at once against each scene's own S=1 steps, bit for bit, the
    robots moving between steps; the peds' yaw (torch's CPU atan2, which
    rounds an element by its place in the tensor) within CROWD_TOL."""
    benv, states, sources, radii = _orca_batch(scene)
    core = benv.core
    start = states.peds.pos

    def crowd(st, k=slice(None)):
        peds, aux = core._crowd_step(st, sources[k], radii[k])
        return st._replace(peds=peds, crowd_aux=aux)

    one = [map_tree(lambda x, k=k: x[k:k + 1], states) for k in range(3)]
    for t in range(BATCH_STEPS):
        states = crowd(states)
        one = [crowd(x, slice(k, k + 1)) for k, x in enumerate(one)]
        want = stack_trees([map_tree(lambda x: x[0], x) for x in one])
        no_yaw = lambda x: (x.peds._replace(yaw=None), x.crowd_aux)
        _assert_bits(no_yaw(states), no_yaw(want), f"crowd at step {t}")
        _assert_crowd_close(states.peds.yaw, want.peds.yaw, f"yaw {t}")
        shift = torch.tensor([0.05, -0.03]) * (t + 1)
        r = states.robots
        states = states._replace(robots=r._replace(
            pose=r.pose + torch.cat([shift, torch.zeros(1)])))
        one = [x._replace(robots=x.robots._replace(
            pose=x.robots.pose + torch.cat([shift, torch.zeros(1)])))
            for x in one]
    return benv, states, start, sources, radii


def _check_orca_batch(scene):
    benv, final, start, sources, radii = _orca_steps_match_scene_by_scene(
        scene)
    pos = final.peds.pos
    # the valid peds moved, and the scenes apart; the invalid one stayed
    assert not torch.equal(pos[:, :2], start[:, :2])
    assert torch.equal(pos[:, 2], start[:, 2])
    assert not torch.equal(pos[0], pos[1])
    assert not torch.equal(pos[1], pos[2])
    # the beeps move the ervoscene crowd, and only it
    _, states, _, _ = _orca_batch(scene)
    beeped = benv.core._crowd_step(states, sources, radii)[0].pos
    silent = benv.core._crowd_step(states, sources, 0.0 * radii)[0].pos
    assert torch.equal(beeped, silent) == (scene == "rvoscene")


def _orca_population(m=7, seed=5):
    """m peds among 2 robots and 4 split rectangles, the last ped
    invalid."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=g)
    lo = 3.0 + 3.0 * u(4, 2)
    segs, _ = split_segments(torch.cat([lo, lo + 0.2 + 0.8 * u(4, 2)], -1),
                             torch.ones(4, dtype=torch.bool))
    pos = 3.0 + 3.0 * u(m, 2)
    return (pos, u(m, 2) - 0.5, 2.0 + 6.0 * u(m, 2), 0.4 + 0.4 * u(m),
            torch.tensor([True] * (m - 1) + [False]), 3.0 + 3.0 * u(2, 2),
            u(2, 2) - 0.5, segs)


def _check_orca_unbatched():
    """The MPC 'orca' head's unbatched call [M, ...] against the S=1 call
    (``predict_orca``, and ``orca_step`` with robots and beeps)."""
    pos, vel, goal, vmax, valid, rpos, rvel, segs = _orca_population()
    one = lambda x: x[None]
    cfg = orca.OrcaConfig(time_step=0.4)
    rvalid = torch.ones(2, dtype=torch.bool)
    radius = torch.full_like(vmax, cfg.radius)
    src, rad = rpos.clone(), torch.tensor([1.0, 0.5])
    bpos, bvel, bsegs = one(pos), one(vel), map_tree(one, segs)
    for t in range(BATCH_STEPS):
        pos, vel = orca.orca_step(
            pos, vel, orca.pref_velocity(pos, goal), radius, vmax, valid,
            rpos, rvel, rvalid, cfg, segs, evac_sources=src, evac_radii=rad)
        bpos, bvel = orca.orca_step(
            bpos, bvel, orca.pref_velocity(bpos, one(goal)), one(radius),
            one(vmax), one(valid), one(rpos), one(rvel), one(rvalid), cfg,
            bsegs, evac_sources=one(src), evac_radii=one(rad))
        _assert_bits((bpos[0], bvel[0]), (pos, vel), f"step {t}")
    assert not torch.equal(pos, _orca_population()[0])
    # the head: H steps without robots, no validity mask
    p0, v0 = _orca_population()[:2]
    head = predict_orca(p0, v0, vmax, BATCH_STEPS, cfg, segs)
    nb = p0.new_zeros((1, 0, 2))
    bp, bv, traj = one(p0), one(v0), []
    goals = bp + bv * 4.0
    for _ in range(BATCH_STEPS):
        bp, bv = orca.orca_step(
            bp, bv, orca.pref_velocity(bp, goals), one(radius), one(vmax),
            torch.ones((1, 7), dtype=torch.bool), nb, nb,
            torch.ones((1, 0), dtype=torch.bool), cfg, bsegs)
        traj.append(bp[0])
    _assert_bits(head, torch.stack(traj), "predict_orca")


@pytest.mark.parametrize("case", ["pedscene", "dataset", "sfm_unbatched",
                                  "rvoscene", "ervoscene", "orca_unbatched"])
def test_batched_crowd_matches_scene_by_scene(case):
    if case == "sfm_unbatched":
        _check_sfm_unbatched()
        return
    if case == "orca_unbatched":
        _check_orca_unbatched()
        return
    if case in ("rvoscene", "ervoscene"):
        _check_orca_batch(case)
        return
    benv, states = (_pedscene_batch if case == "pedscene"
                    else _dataset_batch)()
    final = _steps_match_scene_by_scene(benv, states)
    # the steps moved the crowd, and the scenes apart
    assert not torch.equal(final.peds.pos, states.peds.pos)
    assert not torch.equal(final.peds.pos[0], final.peds.pos[1])
    if case == "dataset":
        np.testing.assert_array_equal(final.step.numpy(),
                                      [BATCH_STEPS, 2 + BATCH_STEPS,
                                       5 + BATCH_STEPS])
