"""On the card: a whole run of each cell's harness at a small size in
float32, through the port's kernels (K2, K3, K4 and their backwards),
against the reference.  Marked ``cuda``; skips where there is no card.

    python -m pytest -q -m cuda perfbench/tests/test_perfbench_card.py
"""

from __future__ import annotations

import pytest
import torch

from perfbench import training
from perfbench_tiny import cells, leaf_shapes, tiny_cell

SMALL = {"moe": dict(d_model=256, n_heads=2, n_kv_heads=1, head_dim=128,
                     n_experts=8, top_k=2, moe_d_ff=128, vocab=1024),
         "dense": dict(d_model=256, n_heads=2, n_kv_heads=1, head_dim=128,
                       d_ff=512, vocab=1024),
         "rwkv": dict(d_model=128, d_ff=256, vocab=1024)}
KERNEL = {"moe": "moe_gmm", "dense": "flash_attention", "rwkv": "rwkv_scan"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", cells())
def test_a_small_run_on_the_card_follows_the_reference(name, card):
    from repro_torch.kernels import ops
    cell = tiny_cell(name)
    m = cell.config["model"]
    m.update(SMALL[m["family"]])
    shapes = leaf_shapes(m)
    cell.config["leaves"] = {k: ["float32", shapes[k], init] for k, (
        _, _, init) in cell.config["leaves"].items()}
    cell.traffic.update(batch=2, seq_len=256)
    res = training.run(cell, 4_000_000_007, 0.5, False, card, 0.0,
                       log=lambda *a, **k: None)
    assert ops.launch_counts()[KERNEL[m["family"]]] > 0
    assert ops.launch_counts()[KERNEL[m["family"]] + "_bwd"] > 0
    for value, _ in res["compared"].values():
        assert value < 1e-3, res["compared"]
