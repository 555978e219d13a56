"""Ped vectors, ped maps (kernel K4's twin) and nearest-ped clearances of
the torch port vs the JAX package, all bit-exact in float32.

The JAX side runs jitted, as in production, through the XLA decode (its
CPU path) and through the Pallas kernel in interpret mode.  Exactness
needs the port to round as XLA's CPU build does: sin/cos with glibc's
bits, the contracted multiply-adds of the base-frame rotation and of
range^2, and a correctly rounded sqrt (ops/f32.py).  A numpy walk of K4's
sortless loop (ascending index, update where range^2 >= best) holds the
kernel's winner rule to the twin on the CPU, and a plain-torch statement
of K4's 64-bit key rule holds it to the twin and to the JAX package on
tie-heavy inputs.
"""

import ctypes
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img_env_tpu.env import observe as jobserve
from img_env_tpu.ops.pallas_pedmap import ped_map_pallas
from img_env_tpu_torch.env import observe
from img_env_tpu_torch.ops import f32, pedmap
from img_env_tpu_torch.ops.raster import div_const

T = torch.as_tensor
MAX_PED, VEC, HS, R_IMG = 10, 7, 48, 0.3


def _scene(seed, n=7, m=40):
    rng = np.random.default_rng(seed)
    poses = np.column_stack([rng.uniform(1, 9, (n, 2)),
                             rng.uniform(-np.pi, np.pi, n)]).astype(np.float32)
    ped_pos = rng.uniform(0, 10, (m, 2)).astype(np.float32)
    ped_vel = rng.uniform(-1, 1, (m, 2)).astype(np.float32)
    ped_r = rng.choice([0.1, 0.17], m).astype(np.float32)
    rob_r = np.full(n, 0.17, np.float32)
    return poses, ped_pos, ped_vel, ped_r, rob_r


def _ties(seed):
    """Duplicate peds (range ties), peds on the +-3 m window edge and on a
    pixel's disc edge, a ped on the robot."""
    poses, ped_pos, ped_vel, ped_r, rob_r = _scene(seed, n=3, m=12)
    poses[:, 2] = [0.0, np.pi / 2, -1.0]
    x, y = poses[0, :2]
    ped_pos[0:3] = [x + 1.0, y + 0.5]          # three-way tie
    ped_pos[3] = [x + 3.0, y - 1.0]            # on the window's +x edge
    ped_pos[4] = [x - 3.0, y + 3.0]            # on a corner
    ped_pos[5] = [x + 0.3, y]                  # disc reaches pixel centres
    ped_pos[6] = [x, y]                        # range 0
    ped_pos[7] = poses[1, :2] + [0.0, 3.0]     # edge of robot 1's window
    ped_pos[8:10] = poses[2, :2] + 0.7         # tie for robot 2
    return poses, ped_pos, ped_vel, ped_r, rob_r


def _jax(poses, ped_pos, ped_vel, ped_r, rob_r):
    with jax.enable_x64(False):
        f = jax.jit(lambda *a: jobserve.ped_vectors_and_map(
            *a, MAX_PED, VEC, HS, R_IMG))
        base = jax.jit(jobserve.peds_in_base)(poses, ped_pos, ped_vel)
        vec, pmap, pmin = f(poses, ped_pos, ped_vel, ped_r, rob_r)
        kern = ped_map_pallas(*base, res=6.0 / HS, ped_image_r=R_IMG,
                              image_size=HS, interpret=True)
    return [np.asarray(x) for x in base], vec, pmap, pmin, kern


@pytest.mark.parametrize("case", ["rand0", "rand1", "rand2", "ties"])
def test_ped_observation_exact(case):
    args = _ties(3) if case == "ties" else _scene(int(case[-1]))
    base_j, vec_j, map_j, min_j, kern_j = _jax(*args)
    base = observe.peds_in_base(T(args[0]), T(args[1]), T(args[2]))
    for got, want in zip(base, base_j):
        np.testing.assert_array_equal(got.numpy(), want)
    vec, pmap, pmin = observe.ped_vectors_and_map(
        *(T(a) for a in args), MAX_PED, VEC, HS, R_IMG)
    np.testing.assert_array_equal(vec.numpy(), np.asarray(vec_j))
    np.testing.assert_array_equal(pmap.numpy(), np.asarray(map_j))
    np.testing.assert_array_equal(pmap.numpy(), np.asarray(kern_j))
    np.testing.assert_array_equal(pmin.numpy(), np.asarray(min_j))
    assert pmap[:, 0].sum() > 0


def test_pallas_tie_case():
    """tests/test_pallas_pedmap.py:40: two peds at one position, the larger
    original index wins; the twin from the JAX base-frame inputs."""
    poses = np.asarray([[5.0, 5.0, 0.3], [4.0, 6.0, -1.0]], np.float32)
    ped_pos = np.asarray([[5.5, 5.2]] * 2 + [[4.4, 6.1]], np.float32)
    ped_vel = np.asarray([[0.1, 0.2], [0.3, -0.4], [0.0, 0.5]], np.float32)
    base_j, _, map_j, _, kern_j = _jax(poses, ped_pos, ped_vel,
                                       np.full(3, 0.1, np.float32),
                                       np.full(2, 0.17, np.float32))
    got = pedmap.ped_map_twin(*(T(np.array(b)) for b in base_j), 6.0 / HS,
                              R_IMG, HS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(kern_j))
    np.testing.assert_array_equal(got.numpy(), np.asarray(map_j))
    # robot 0 sees the two stacked peds; their pixels carry ped 1's
    # base-frame velocity, not ped 0's
    vx = set(got[0, 1][got[0, 0] > 0].tolist())
    assert float(base_j[2][0, 1]) in vx
    assert float(base_j[2][0, 0]) not in vx


def _emulate_kernel(px, py, vx, vy, res, r_img, hs):
    """csrc/pedmap.cu's loop in numpy float32: peds in ascending index, a
    covering ped replaces the incumbent where range^2 >= best."""
    f = np.float32
    n, m = px.shape
    rsq = pedmap.range_sq(T(px), T(py)).numpy()
    inv = f(1.0) / f(res)
    r2 = f(float(r_img) ** 2)
    h = np.arange(hs, dtype=f)[:, None] * np.ones((1, hs), f)
    w = h.T.copy()
    xc, yc = (h + f(0.5)) * f(res), (w + f(0.5)) * f(res)
    out = np.zeros((n, 3, hs, hs), f)
    for a in range(n):
        best = np.full((hs, hs), -1.0, f)
        bvx, bvy = np.zeros((hs, hs), f), np.zeros((hs, hs), f)
        for i in range(m):
            x, y = f(px[a, i]), f(py[a, i])
            in_w = -3 <= x <= 3 and -3 <= y <= 3
            tx = f(-x + f(3)) if in_w else f(1e9)
            ty = f(-y + f(3))
            box = ((h >= np.floor((tx - f(r_img)) * inv))
                   & (h < np.floor((tx + f(r_img)) * inv))
                   & (w >= np.floor((ty - f(r_img)) * inv))
                   & (w < np.floor((ty + f(r_img)) * inv)))
            dx, dy = xc - tx, yc - ty
            upd = box & (dx * dx + dy * dy < r2) & (rsq[a, i] >= best)
            best = np.where(upd, rsq[a, i], best)
            bvx = np.where(upd, vx[a, i], bvx)
            bvy = np.where(upd, vy[a, i], bvy)
        occ = best >= 0
        out[a] = [occ.astype(f), np.where(occ, bvx, 0), np.where(occ, bvy, 0)]
    return out


@pytest.mark.parametrize("case", ["rand4", "ties"])
def test_kernel_winner_rule_matches_twin(case):
    args = _ties(5) if case == "ties" else _scene(4, n=3, m=30)
    base = [b.numpy() for b in observe.peds_in_base(*(T(a)
                                                      for a in args[:3]))]
    want = pedmap.ped_map_twin(*(T(b) for b in base), 6.0 / HS, R_IMG, HS)
    got = _emulate_kernel(*base, 6.0 / HS, R_IMG, HS)
    np.testing.assert_array_equal(got, want.numpy())


def _key_rule(px, py, vx, vy, res, r_img, hs):
    """csrc/pedmap.cu's rule in plain torch: each in-window ped i carries
    the key (float_bits(range^2) << 32) | (i + 1); a scatter-amax of the
    keys over the pixels of each ped's index box, clipped to the map, that
    lie strictly inside its disc leaves each pixel its winner's key (0:
    no ped)."""
    n, m = px.shape
    half = pedmap.HALF
    rsq = pedmap.range_sq(px, py)
    key = (rsq.view(torch.int32).long() << 32) | torch.arange(1, m + 1)
    in_w = (px <= half) & (px >= -half) & (py <= half) & (py >= -half)
    tx, ty = -px + half, -py + half
    clip = lambda v: torch.floor(div_const(v, res)).clamp(0, hs)[..., None]
    idx = torch.arange(hs)
    box_h = (idx >= clip(tx - r_img)) & (idx < clip(tx + r_img))
    box_w = (idx >= clip(ty - r_img)) & (idx < clip(ty + r_img))
    centre = (idx.to(px.dtype) + 0.5) * res
    dx, dy = centre - tx[..., None], centre - ty[..., None]
    d2 = (dx * dx)[..., :, None] + (dy * dy)[..., None, :]
    pairs = (in_w[..., None, None] & box_h[..., :, None]
             & box_w[..., None, :] & (d2 < pedmap._r2(r_img)))
    r_i, p_i, h_i, w_i = pairs.nonzero(as_tuple=True)
    keys = torch.zeros(n * hs * hs, dtype=torch.int64).scatter_reduce_(
        0, (r_i * hs + h_i) * hs + w_i, key[r_i, p_i], "amax")
    occ = keys != 0
    win = ((keys & 0xFFFFFFFF) - 1).clamp(min=0).view(n, hs * hs)
    pick = lambda v: torch.where(
        occ, torch.gather(v, 1, win).view(-1), torch.zeros(()))
    return torch.stack([occ.to(px.dtype), pick(vx), pick(vy)]).view(
        3, n, hs, hs).transpose(0, 1)


def _tie_heavy(seed):
    """Three robots at yaw 0, robot 0 on the origin (its base frame is the
    world frame, exactly); 40 peds in a seeded order: random peds on a
    1/64 m grid, four stacked on one point, four at one range^2 at
    overlapping places, two at range 0, six on or just past the +-3 m
    window's edges and corners, and one each at a subnormal range^2
    (1e-20, 0), at +0 from (-0, -0) and at a range^2 that underflows to 0
    (1e-23, -1e-23)."""
    rng = np.random.default_rng(seed)
    poses = np.float32([[0.0, 0.0, 0.0], [0.5, -0.25, 0.0],
                        [-1.0, 2.0, 0.0]])
    special = [[0.75, 0.5]] * 4 + [[1.0, 0.25], [1.0, -0.25], [-1.0, 0.25],
                                   [0.25, 1.0]] + [[0.0, 0.0]] * 2 + [
        [3.0, 1.0], [-3.0, -2.0], [1.5, 3.0], [3.0, 3.0],
        [np.nextafter(np.float32(3), np.float32(4)), 0.0], [-3.0, 3.0],
        [1e-20, 0.0], [-0.0, -0.0], [1e-23, -1e-23]]
    grid = np.round(rng.uniform(-3.5, 3.5, (40 - len(special), 2)) * 64) / 64
    ped_pos = np.concatenate([np.float32(special), grid]).astype(np.float32)
    order = rng.permutation(len(ped_pos))
    ped_pos = ped_pos[order]
    ped_vel = rng.uniform(-1, 1, ped_pos.shape).astype(np.float32)
    ped_r = np.full(len(ped_pos), 0.1, np.float32)
    return poses, ped_pos, ped_vel, ped_r, np.full(3, 0.17, np.float32)


@pytest.mark.parametrize("seed", range(3))
def test_key_rule_matches_twin_and_jax(seed):
    """K4's 64-bit key rule == ped_map_twin == the JAX package's Pallas
    kernel (interpret mode) and its XLA ped map, on tie-heavy inputs; the
    port's whole ped observation equals the JAX package's there too."""
    args = _tie_heavy(seed)
    base_j, vec_j, map_j, min_j, kern_j = _jax(*args)
    vec, pmap, pmin = observe.ped_vectors_and_map(
        *(T(a) for a in args), MAX_PED, VEC, HS, R_IMG)
    for got, want in ((vec, vec_j), (pmap, map_j), (pmin, min_j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    base = observe.peds_in_base(*(T(a) for a in args[:3]))
    for got, want in zip(base, base_j):
        np.testing.assert_array_equal(got.numpy(), want)
    # robot 0's peds: +0 and subnormal range^2 before the flush, 0 after
    raw = f32.fma(base[0][0], base[0][0], base[1][0] * base[1][0])
    tiny = (raw < 1.1754944e-38) & (raw > 0)
    assert (raw == 0).sum() >= 4 and tiny.any()
    assert (pedmap.range_sq(base[0][0], base[1][0])[tiny] == 0).all()
    rule = _key_rule(*base, 6.0 / HS, R_IMG, HS)
    twin = pedmap.ped_map_twin(*base, 6.0 / HS, R_IMG, HS)
    np.testing.assert_array_equal(rule.numpy(), twin.numpy())
    np.testing.assert_array_equal(rule.numpy(), np.asarray(kern_j))
    np.testing.assert_array_equal(rule.numpy(), np.asarray(map_j))
    assert rule[:, 0].sum() > 0


def test_twin_ties_go_to_the_larger_index():
    """Two peds on one point: the pixels they cover carry the velocity of
    the one with the larger index, whichever order they come in."""
    px, py = torch.tensor([[1.0, 1.0, -2.0]]), torch.tensor([[0.5, 0.5, 1.0]])
    vx, vy = torch.tensor([[0.1, 0.2, 0.3]]), torch.tensor([[-0.1, -0.2, 0.0]])
    for perm in ([0, 1, 2], [1, 0, 2]):
        out = pedmap.ped_map_twin(px[:, perm], py[:, perm], vx[:, perm],
                                  vy[:, perm], 6.0 / HS, R_IMG, HS)
        occ = out[0, 0] > 0
        x = float(px[0, 0])
        stacked = occ[int((3.0 - x) * HS / 6.0)]      # a row of their disc
        assert stacked.any()
        assert set(out[0, 1][int((3.0 - x) * HS / 6.0)][stacked].tolist()) \
            == {float(vx[0, perm[1]])}


def test_sin_cos_have_the_xla_bits():
    """XLA's CPU sin/cos are glibc's sinf/cosf; ops/f32.sin_cos reproduces
    them, including the small-argument and reduction branches."""
    rng = np.random.default_rng(0)
    y = np.concatenate([rng.uniform(-3.3, 3.3, 20000),
                        rng.uniform(-0.8, 0.8, 5000),
                        rng.uniform(-1e-3, 1e-3, 2000),
                        rng.uniform(-110, 110, 3000),
                        [0.0, -0.0, 1e-30, np.pi, -np.pi, np.pi / 2,
                         np.pi / 4, 0.75, 0.8125]]).astype(np.float32)
    with jax.enable_x64(False):
        s_j = np.asarray(jax.jit(jnp.sin)(y))
        c_j = np.asarray(jax.jit(jnp.cos)(y))
    s, c = f32.sin_cos(T(y))
    np.testing.assert_array_equal(s.numpy(), s_j)
    np.testing.assert_array_equal(c.numpy(), c_j)
    libm = ctypes.CDLL("libm.so.6")
    libm.cosf.restype = ctypes.c_float
    libm.cosf.argtypes = [ctypes.c_float]
    assert all(np.float32(libm.cosf(float(v))) == w
               for v, w in zip(y[:200], c.numpy()[:200]))


def test_sqrt_and_fma_round_once():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 30, 50000).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(jnp.sqrt)(x))
    np.testing.assert_array_equal(f32.sqrt(T(x)).numpy(), want)
    assert f32.sqrt(T(np.float32([8.52319622039795]))).item() == \
        float(np.sqrt(np.float32(8.52319622039795)))
    a, b = (rng.uniform(-5, 5, 50000).astype(np.float32) for _ in range(2))
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(lambda a, b: a * a + b * b)(a, b))
    np.testing.assert_array_equal(pedmap.range_sq(T(a), T(b)).numpy(), want)


def test_sin_cos_beyond_the_fast_reduction():
    """|y| >= 120 leaves glibc's fast path (and the int32 quotient's range
    past ~200): the float64 sin/cos rounded to float32 stay within an ulp
    of XLA's, and the base frame of a robot that has turned for a long
    time stays right."""
    rng = np.random.default_rng(2)
    y = np.concatenate([[119.99, 120.0, -120.0, 150.0, 202.0, 300.0, -300.0,
                         1e4, 3e6], rng.uniform(-1e5, 1e5, 2000)]
                       ).astype(np.float32)
    with jax.enable_x64(False):
        s_j = np.asarray(jax.jit(jnp.sin)(y))
        c_j = np.asarray(jax.jit(jnp.cos)(y))
    s, c = f32.sin_cos(T(y))
    ulp = lambda v: np.spacing(np.abs(v).astype(np.float32))
    assert (np.abs(s.numpy() - s_j) <= ulp(s_j)).all()
    assert (np.abs(c.numpy() - c_j) <= ulp(c_j)).all()
    poses, ped_pos, ped_vel, _, _ = _scene(6)
    poses[:, 2] = np.float32([150.0, 300.0, -300.0, 1e4, 207.3, -151.0, 5.0])
    with jax.enable_x64(False):
        base_j = jax.jit(jobserve.peds_in_base)(poses, ped_pos, ped_vel)
    base = observe.peds_in_base(T(poses), T(ped_pos), T(ped_vel))
    for got, want in zip(base, base_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _fma_exact(a, b, c):
    """float32 nearest to the exact a * b + c, ties to even."""
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    g = np.float32(float(v))
    near = [np.nextafter(g, np.float32(-np.inf)), g,
            np.nextafter(g, np.float32(np.inf))]
    return min(near, key=lambda q: (abs(Fraction(float(q)) - v),
                                    int(np.float32(q).view(np.int32)) & 1))


def test_fma_has_no_double_rounding():
    """Sums that float64 rounds onto a float32 midpoint: rounding the
    float64 a * b + c again would land on the wrong neighbour; ops/f32.fma
    matches the exactly rounded value, XLA's contraction and, on random
    inputs, both."""
    a = np.float32([4097 / 4096, 4097 / 4096, 1 + 2 ** -23])
    b = np.float32([4097 / 4096, 4099 / 4096, 2 ** -24 * (1 - 2 ** -23)])
    c = np.float32([2 ** -60, -2 ** -60, 1 + 2 ** -23])
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    exact = np.float32([_fma_exact(*x) for x in zip(a, b, c)])
    assert (twice != exact).all()
    rng = np.random.default_rng(3)
    ra, rb, rc = (rng.uniform(-5, 5, 20000).astype(np.float32)
                  for _ in range(3))
    rc[::3] *= np.float32(1e-9)
    a, b, c = (np.concatenate(p) for p in ((a, ra), (b, rb), (c, rc)))
    got = f32.fma(T(a), T(b), T(c)).numpy()
    with jax.enable_x64(False):
        xla = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    np.testing.assert_array_equal(got[:3], exact)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(
        got[:500], [_fma_exact(*x) for x in zip(a[:500], b[:500], c[:500])])
    inf = np.float32([np.inf, -np.inf, 1.0])
    assert f32.fma(T(inf), T(np.ones(3, np.float32)),
                   T(np.float32([0, 1, np.nan]))).numpy().tolist()[:2] == \
        [np.inf, -np.inf]


def test_empty_crowd_map():
    out = pedmap.ped_map(torch.zeros((3, 0)), torch.zeros((3, 0)),
                         torch.zeros((3, 0)), torch.zeros((3, 0)), 0.125,
                         R_IMG, HS)
    assert out.shape == (3, 3, HS, HS) and not out.any()
