"""On the card, at a cell's own size: the program reads under every limit
of the cell's check and the control (the reference in bfloat16) fails one.
Marked ``cuda``: skips without a card.

    python -m pytest navbench/tests -q -m cuda
"""

import json
import os

import pytest
import torch

import tiny
from navbench import check, control, run

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def bench():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.set_caches(tiny.ROOT)
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json"),
              encoding="utf-8") as f:
        return json.load(f)


@pytest.mark.parametrize("cell", ["bench200.step", "stage5.eval50"])
def test_card_cell_against_control(bench, cell):
    limits = check.load_limits(os.path.join(tiny.HERE, "checks",
                                            cell + ".json"))
    got = control.readings(bench, cell, 2 ** 31 + 99, ["bf16"], "cuda")
    ok, rows = check.judge(got["float32"], limits)
    assert ok, rows
    ok, rows = check.judge(got["bf16"], limits)
    assert not ok, rows
