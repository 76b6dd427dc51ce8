"""On the card: each cell at its own size for a short window is correct,
and its precision control, the reference in bfloat16 in the program's
place, is not. Skips where there is no card.

    python -m pytest perfbench/tests/test_perfbench_card.py -m cuda
"""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("control", [False, True], ids=["program",
                                                        "control"])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the port's kernels")
    from pbench import cell, spec
    c = spec.load(ROOT, name)
    out = cell.run(c, 3_000_000_019, 2.0, False, torch.device("cuda", 0),
                   time.perf_counter(), control=control)
    assert out["correct"] is (not control), out["checks"]
