"""float32 arithmetic with the bits the JAX package gets on the CPU.

The JAX package's CPU build (XLA) differs from plain torch float32 in four
places that the crowd observation and the log-polar laser map read:

* ``sin``/``cos`` are glibc's ``sinf``/``cosf``.  ``sin_cos`` evaluates the
  same algorithm (a double-precision range reduction by pi/2 and two
  double-precision polynomials, rounded once to float32) in float64
  tensor ops, so it gives those bits on any device: the CPU and the card
  agree with each other and with XLA.  torch's own float32 ``sin``/``cos``
  differ from them in the last bit for a few percent of arguments.
* XLA contracts ``a * b + c`` into one fused multiply-add.  ``fma``
  rounds the exact ``a * b + c`` once to float32.
* XLA's float32 ``sqrt`` is correctly rounded; torch's CPU one is not
  always (it can land one ulp low).  ``sqrt`` takes the float64 root and
  rounds it, which is the correctly rounded float32 root.
* XLA's float32 ``exp`` and ``log`` are its own polynomial approximations
  (Eigen's Cephes forms, contracted into fused multiply-adds, with
  subnormals flushed), not the correctly rounded values torch is close
  to.  ``exp`` and ``log`` spell the same arithmetic out in float32 ops
  and ``fma``, so the card and the CPU get XLA's bits.
"""

from __future__ import annotations

import torch

_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")     # 2/pi * 2^24
_HPI = float.fromhex("0x1.921fb54442d18p0")           # pi/2
_C = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_S = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))
_FAST_MAX = 120.0        # glibc's single-step reduction covers |y| < 120


def sin_cos(y):
    """(sin y, cos y) float32.  For |y| < 120 (robot yaw is not wrapped,
    so a robot that keeps turning leaves this range) the bits are glibc's:
    its reduction by pi/2 (for |y| < 0.75 glibc skips
    it, but n is 0 there and the polynomials give the same bits, its
    |y| < 2^-12 shortcuts included), then one sine and one cosine
    polynomial whose roles swap for odd n.  Beyond, where glibc reduces
    with a 4/pi table, the float64 sin/cos rounded to float32: correct,
    without the bit parity.  Other dtypes take torch's sin/cos."""
    if y.dtype != torch.float32:
        return torch.sin(y), torch.cos(y)
    x = y.to(torch.float64)
    far = y.abs() >= _FAST_MAX
    xf = torch.where(far, 0.0, x)          # keeps the int32 quotient in range
    n = ((xf * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    xr = xf - n.to(torch.float64) * _HPI
    x2 = xr * xr
    xs = torch.where(((n + 1) & 2) != 0, -xr, xr)    # n & 3 in (1, 2)
    x3 = xs * x2
    sv = (xs + x3 * _S[0]) + (x3 * x2) * (_S[1] + x2 * _S[2])
    x4 = x2 * x2
    cv = ((_C[0] + x2 * _C[1]) + x4 * _C[2]) + (x4 * x2) * (_C[3] + x2 * _C[4])
    cv = torch.where((n & 2) != 0, -cv, cv)
    odd = (n & 1) != 0
    sin = torch.where(far, torch.sin(x), torch.where(odd, cv, sv))
    cos = torch.where(far, torch.cos(x), torch.where(odd, sv, cv))
    return sin.to(torch.float32), cos.to(torch.float32)


def fma(a, b, c):
    """float32 ``a * b + c`` rounded once, as a fused multiply-add (and
    XLA's contraction) computes it; other dtypes compute it as written.

    The product of two float32 values is exact in float64.  The float64
    sum is rounded to odd: where it is inexact (TwoSum gives its error) and
    its last bit is even, it moves one step toward the exact value.  A
    float64 rounded to odd then rounds to float32 as the exact value
    would, so no double rounding can land on a float32 midpoint."""
    if c.dtype != torch.float32:
        return a * b + c
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    cb = s - p
    err = (p - (s - cb)) + (c - cb)        # s + err == p + c exactly
    bits = s.view(torch.int64)
    fix = (err.abs() > 0) & ((bits & 1) == 0)    # NaN err (s = inf): no fix
    step = torch.where((err > 0) == (s > 0), 1, -1)   # +1: larger magnitude
    bits = torch.where(fix, bits + step, bits)
    return bits.view(torch.float64).to(torch.float32)


def sqrt(x):
    """Correctly rounded float32 square root (on the CPU and the card)."""
    if x.dtype != torch.float32:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


_TINY = 1.1754943508222875e-38          # the least normal float32
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 0.5)
_LN2_HI, _LN2_LO = 0.693359375, -2.12194440e-4
_LOG_P = ((7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1),
          (-1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1),
          (2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))


def _const(v: float, like):
    return torch.full_like(like, v)


def exp(x):
    """float32 ``exp`` with the bits of XLA's CPU build: x clamped to
    [-87.8, 88.8], n = floor(x log2(e) + 1/2) clamped to [-127, 127],
    r = x - n ln2 in two parts, a degree-5 polynomial in Horner form
    (fused multiply-adds), 1 + r + r^2 p(r), times 2^n; a subnormal result
    is flushed to 0."""
    x = torch.clamp(x, -87.80000305175781, 88.80000305175781)
    n = torch.floor(fma(x, _const(1.4426950408889634, x), _const(0.5, x)))
    n = torch.clamp(n, -127.0, 127.0)
    r = fma(-n, _const(_LN2_HI, x), x)
    r = fma(-n, _const(_LN2_LO, x), r)
    y = _const(_EXP_P[0], x)
    for p in _EXP_P[1:]:
        y = fma(y, r, _const(p, x))
    y = fma(y, r * r, r) + 1.0
    out = y * ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(out.abs() < _TINY, torch.zeros_like(out), out)


def log(x):
    """float32 ``log`` with the bits of XLA's CPU build: x = m 2^e with m
    in [sqrt(1/2), sqrt(2)), f = m - 1, f - f^2/2 + f^3 q(f) with q a
    degree-8 polynomial in three fused Horner pieces, plus e ln2 in two
    parts; a subnormal input counts as 0 (-inf), a negative one or NaN
    gives NaN."""
    xm = torch.clamp(x, min=_TINY)
    bits = xm.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)
    low = m < 0.7071067690849304          # sqrt(1/2) in float32
    f = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.to(torch.float32)
    f2 = f * f
    f3 = f2 * f
    q = [fma(fma(_const(a, x), f, _const(b, x)), f, _const(c, x))
         for a, b, c in _LOG_P]
    y = fma(f3, fma(q[0], f3, q[1]), q[2])
    y = fma(y, f3, e * _LN2_LO)
    out = fma(_const(_LN2_HI, x), e, fma(_const(-0.5, x), f2, f) + y)
    out = torch.where(x == float("inf"), x, out)
    out = torch.where(x.abs() < _TINY, _const(-float("inf"), x), out)
    return torch.where((x <= -_TINY) | torch.isnan(x),
                       _const(float("nan"), x), out)
