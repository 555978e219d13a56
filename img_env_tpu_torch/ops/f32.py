"""float32 arithmetic with the bits the JAX package gets on the CPU.

The JAX package's CPU build (XLA) differs from plain torch float32 in three
places that the crowd observation reads:

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
