"""On the card: a whole run of each cell's harness at a small size in
float32, through the port's kernels (K2, K3, K4 and their backwards: each
configuration names those it must launch under ``tests``), against the
reference.  Marked ``cuda``; skips where there is no card.

    python -m pytest -q -m cuda perfbench/tests/test_perfbench_card.py
"""

from __future__ import annotations

import pytest
import torch

from perfbench import training
from perfbench_tiny import cells, small_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", cells())
def test_a_small_run_on_the_card_follows_the_reference(name, card):
    from repro_torch.kernels import ops
    cell = small_cell(name)
    res = training.run(cell, 4_000_000_007, 0.5, False, card, 0.0,
                       log=lambda *a, **k: None)
    for kernel in cell.config["tests"]["kernels"]:
        assert ops.launch_counts()[kernel] > 0
        assert ops.launch_counts()[kernel + "_bwd"] > 0
    for value, _ in res["compared"].values():
        assert value < 1e-3, res["compared"]
