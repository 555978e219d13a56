"""The episode clearance field (``mpc.edt.edt2d_device``) on CPU tensors,
which runs its plain-torch twin, against a brute-force numpy reference of
the clipped transform: exact column distances from the nearest occupied
row above and below, then an explicit windowed minimum over the row
offsets.  The squared distances in cells are compared exactly (integers);
the meters are the float32 product of the resolution with a square root
within one ulp of the correctly rounded one: torch's CPU ``sqrt`` is not
always correctly rounded (one ulp low on 223 of the integers below 40,000),
and a one-ulp root can give a product two ulps off.  So the twin is held to
the formula here, and the kernel to the twin's bits on the card
(``tests/test_torch_cuda_kernels.py``)."""

import json
import math
import os

import numpy as np
import pytest
import torch

import img_env_tpu_torch
from img_env_tpu_torch.config import EnvConfig
from img_env_tpu_torch.env.maps import load_static_map
from img_env_tpu_torch.mpc.edt import edt2d_device, edt2d_sq_twin
from img_env_tpu_torch.ops import kernels


def reference_d2(occ: np.ndarray, clip: int) -> np.ndarray:
    """int64 [..., H, W]: min over |o| <= clip, 0 <= j - o < W of
    min(gv, clip)^2 at (i, j - o) + o^2, gv the rows to the nearest
    occupied cell of the column (any distance past clip in an empty
    column)."""
    h, w = occ.shape[-2:]
    rows = np.arange(h)[:, None]
    far = 1 << 30
    above = np.maximum.accumulate(np.where(occ, rows, -far), axis=-2)
    below = np.flip(np.minimum.accumulate(
        np.flip(np.where(occ, rows, far), -2), axis=-2), -2)
    g2 = np.minimum(np.minimum(rows - above, below - rows), clip) ** 2
    d2 = g2.copy()
    for o in range(1, min(clip, w - 1) + 1):
        d2[..., o:] = np.minimum(d2[..., o:], g2[..., :-o] + o * o)
        d2[..., :-o] = np.minimum(d2[..., :-o], g2[..., o:] + o * o)
    return d2


def _blobs(h, w, n, seed):
    """n random discs and boxes of occupied cells in an [h, w] map."""
    rng = np.random.default_rng(seed)
    occ = np.zeros((h, w), bool)
    ii, jj = np.mgrid[:h, :w]
    for k in range(n):
        ci, cj = rng.integers(0, h), rng.integers(0, w)
        r = int(rng.integers(2, max(3, min(h, w) // 8)))
        if k % 2:
            occ |= (ii - ci) ** 2 + (jj - cj) ** 2 <= r * r
        else:
            occ[max(0, ci - r):ci + r, max(0, cj - r // 2):cj + r // 2] = True
    return occ


def _stage5_map():
    """The stage-5 curriculum's room at 0.015 m (733 x 733) with ten
    sampled-size obstacles stamped in, as a reset composes it, and its
    reset's clip (2 m in cells)."""
    path = os.path.join(os.path.dirname(img_env_tpu_torch.__file__),
                        "artifacts", "stage5_policy_env.json")
    with open(path) as f:
        cfg = EnvConfig.from_dict(json.load(f))
    occ = load_static_map(cfg) < 250
    rng = np.random.default_rng(5)
    ii, jj = np.mgrid[:occ.shape[0], :occ.shape[1]]
    for _ in range(10):
        ci, cj = rng.integers(150, 583, 2)
        r = int(rng.integers(7, 34))        # 0.1-0.5 m
        occ |= (ii - ci) ** 2 + (jj - cj) ** 2 <= r * r
    return occ, 0.015, int(min(256, max(64, math.ceil(2.0 / 0.015))))


def _one_cell():
    occ = np.zeros((40, 50), bool)
    occ[17, 23] = True
    return occ, 0.05, 16


CASES = {
    "empty": lambda: (np.zeros((40, 50), bool), 0.05, 16),
    "one_cell": _one_cell,
    "full": lambda: (np.ones((30, 30), bool), 0.1, 8),
    "narrow": lambda: (_blobs(60, 20, 4, 1), 0.05, 16),   # W < 2 clip + 1
    "non_square": lambda: (_blobs(37, 91, 6, 2), 0.05, 24),
    "stage5": _stage5_map,
    "clip64": lambda: (_blobs(200, 300, 12, 3), 0.015, 64),
    "scenes": lambda: (np.stack([_blobs(45, 70, 5, s) for s in range(3)]),
                       0.05, 20),
}


@pytest.mark.parametrize("case", list(CASES))
def test_edt_twin_matches_reference(case):
    occ, res, clip = CASES[case]()
    want = reference_d2(occ, clip)
    occ_t = torch.as_tensor(occ)
    d2 = edt2d_sq_twin(occ_t, clip)
    assert d2.dtype == torch.float32
    np.testing.assert_array_equal(d2.numpy().astype(np.int64), want)
    got = edt2d_device(occ_t, res, clip_cells=clip)
    assert got.dtype == torch.float32 and got.shape == occ_t.shape
    # the float32 product of the resolution with a square root of d2
    # within one ulp of the correctly rounded one
    root, inf, r = (np.sqrt(want.astype(np.float32)), np.float32(np.inf),
                    np.float32(res))
    near = [np.nextafter(root, -inf), root, np.nextafter(root, inf)]
    assert all(x.dtype == np.float32 for x in near)
    ok = np.zeros(want.shape, bool)
    for x in near:
        ok |= got.numpy() == x * r
    assert ok.all()


def test_edt_kernel_is_built_and_counted():
    """csrc/edt.cu is one of the sources the kernel library builds, and
    its launches are counted under ``edt``."""
    assert "edt.cu" in kernels.SOURCES
    assert "edt" in kernels.LAUNCHES
    assert kernels._SIGNATURES["edt"][0] == "img_env_edt"
