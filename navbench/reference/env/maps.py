"""Static map loading (host side, once per environment construction).

The same grid as ``img_env_tpu.env.maps.load_static_map`` without OpenCV or
PIL: the PNG is decoded with the standard library (``zlib``, ``struct``),
converted to grey the way ``cv2.IMREAD_GRAYSCALE`` does (libpng's fixed-point
``rgb_to_gray`` with OpenCV's 0.299 / 0.587 weights, alpha stripped) and
resampled with ``cv2.resize``'s INTER_LINEAR arithmetic for uint8 (11-bit
fixed-point taps, the vectorised vertical pass's rounding).  A one-level
grey difference would move a cell across the 250 free threshold
(``CELL_FREE_MIN``), so the result is held array-equal to the cv2 loader.

Row index corresponds to world x, column index to world y (``world2map``:
m = round(x/res), n = round(y/res), grid_map.cpp:40-44).
"""

from __future__ import annotations

import functools
import struct
import zlib

import numpy as np

from navbench.reference.config import EnvConfig

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}      # PNG colour type -> samples/pixel
_COEF_BITS = 11                           # cv2 INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (types 0-4)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    pos = 0
    for y in range(h):
        ft = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int64)
        pos += 1 + stride
        if ft == 0:
            cur = line
        elif ft == 2:
            cur = (line + prev) & 0xFF
        elif ft in (1, 3, 4):
            cur = np.zeros(stride, np.int64)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ft}")
        out[y] = cur
        prev = cur
    return out


def decode_png(path: str) -> np.ndarray:
    """uint8 [H, W, C] samples of an 8-bit, non-interlaced PNG of colour
    type 0 (grey), 2 (RGB), 4 (grey+alpha) or 6 (RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, hdr, idat = 8, None, []
    while pos + 8 <= len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace}); only 8-bit non-interlaced "
            "types 0/2/4/6 are read")
    ch = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    return _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)


def to_grey(img: np.ndarray) -> np.ndarray:
    """cv2.IMREAD_GRAYSCALE of decoded samples: alpha is stripped, colour
    goes through libpng's rgb_to_gray with weights 0.299 / 0.587 as fixed
    15-bit integers (9797, 19234, 3737), truncated; grey pixels pass."""
    if img.shape[2] <= 2:
        return img[..., 0].copy()
    rgb = img[..., :3].astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    grey = (r * 9797 + g * 19234 + b * 3737) >> 15
    return np.where((r == g) & (g == b), r, grey).astype(np.uint8)


def _taps(dst: int, src: int, clamp: bool):
    """cv2's per-output (index0, index1, coef0, coef1) for INTER_LINEAR: the
    source coordinate in float32 from scale = 1 / (dst / src); x clamps its
    coefficient at the borders, y only clamps the row indices."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        lo = s < 0
        f[lo], s[lo] = 0, 0
        hi = s >= src - 1
        f[hi], s[hi] = 0, src - 1
    c0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE))
    c1 = np.rint(f * np.float32(_COEF_SCALE))
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1),
            c0.astype(np.int64), c1.astype(np.int64))


def resize_linear_u8(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` (INTER_LINEAR) for a uint8 [H, W] grid."""
    y0, y1, b0, b1 = _taps(h, img.shape[0], clamp=False)
    x0, x1, a0, a1 = _taps(w, img.shape[1], clamp=True)
    im = img.astype(np.int64)
    rows = im[:, x0] * a0 + im[:, x1] * a1          # horizontal pass, exact
    s0, s1 = rows[y0] >> 4, rows[y1] >> 4
    v = (((s0 * b0[:, None]) >> 16) + ((s1 * b1[:, None]) >> 16) + 2) >> 2
    return v.astype(np.uint8)


@functools.lru_cache(maxsize=32)
def _load_resized(path: str, global_res: float, view_res: float) -> np.ndarray:
    img = to_grey(decode_png(path))
    h = int(img.shape[0] * global_res / view_res)
    w = int(img.shape[1] * global_res / view_res)
    return np.ascontiguousarray(resize_linear_u8(img, h, w))


def load_static_map(cfg: EnvConfig) -> np.ndarray:
    """uint8 [H, W] occupancy at ``view_map_resolution``."""
    return _load_resized(
        cfg.resolve_map_path(), float(cfg.global_resolution),
        float(cfg.view_map_resolution))
