"""The control of each cell at the tiny size on the CPU: the reference
one precision below the configuration's bf16, put in the program's
place (every product in fp8: operands in e4m3, output gradients in
e5m2; the parameters the configuration keeps in bf16 stored in bf16, as
the program stores them), must come out not correct under the cell's
limits.
``perfbench/control.py`` reads the same on the card at the cell's own
size."""

from __future__ import annotations

import pytest
import torch

from perfbench import compare, traffic
from perfbench.reference import train as reference
from perfbench_tiny import cells, tiny_cell


@pytest.mark.parametrize("name", cells())
def test_the_fp8_control_is_not_correct(name):
    cell = tiny_cell(name)
    leaves = {k: ["bfloat16", shape, init] for k, (_, shape, init)
              in cell.config["leaves"].items()}
    cell.config["leaves"] = leaves
    batches = traffic.device_batches(cell.traffic,
                                     cell.config["model"]["vocab"], 3,
                                     2_147_483_701, "cpu")
    base = reference.train(cell.config, 2_147_483_701, batches, "cpu")
    ctl = reference.train(cell.config, 2_147_483_701, batches, "cpu",
                          prec="fp8", store="bf16")
    ok, shown = compare.verdict(
        compare.gaps(ctl, base, cell.limits.get("leaves")), cell.limits)
    assert not ok, shown


def test_fp8_rounds_both_ways():
    from perfbench.reference.common import mm
    g = torch.Generator().manual_seed(3)
    a = torch.randn(8, 16, generator=g, requires_grad=True)
    b = torch.randn(16, 4, generator=g, requires_grad=True)
    out = mm("fp8", "ij,jk->ik", a, b)
    exact = a @ b
    assert 0 < (out - exact).abs().max() < 0.2 * exact.abs().max()
    out.sum().backward()
    ga = a.grad.clone()
    a.grad = None
    exact.sum().backward()
    assert not torch.equal(ga, a.grad)


def test_rows_gap_sees_the_noise_that_a_norm_averages_away():
    """Per-element noise of 5% moves a leaf's norm by about a thousandth
    and each row's mean square by several times that."""
    from perfbench import weights
    g = torch.Generator().manual_seed(5)
    ref = {"w": [torch.randn(64, 512, generator=g) for _ in range(2)],
           "b": [torch.randn(512, generator=g)]}
    noisy = {k: [t * (1 + 0.05 * torch.randn(t.shape, generator=g))
                 for t in ts] for k, ts in ref.items()}
    norm = {k: float(torch.stack([t.norm() for t in ts]).norm())
            for k, ts in ref.items()}
    norm_noisy = {k: float(torch.stack([t.norm() for t in ts]).norm())
                  for k, ts in noisy.items()}
    norm_gap = max(abs(norm_noisy[k] - norm[k]) / norm[k] for k in norm)
    assert norm_gap < 3e-3
    gaps = compare.rows_gaps(weights.row_means_sq(noisy),
                             weights.row_means_sq(ref))
    assert gaps["w"] > max(5e-3, 3 * norm_gap)
    same = compare.rows_gaps(weights.row_means_sq(ref),
                             weights.row_means_sq(ref))
    assert max(same.values()) == 0
