"""A run of each cell at the tiny size on the CPU, the timed path broken
underneath, must come out not correct: for each fault a training cell
can have on one card (a step that leaves the state unchanged; half of
the batch left out, the mean over the rest; an answer altered where it
is produced: one leaf's gradient doubled as the backward hands it to
the optimizer)."""

from __future__ import annotations

import pytest
import torch

from perfbench import training
from perfbench_tiny import cells, tiny_cell


def _unchanged(monkeypatch):
    import repro_torch.train.train_step as ts

    def no_update(cfg, params, grads, state):
        return params, state, {"grad_norm": torch.zeros(()),
                               "lr": torch.zeros(())}
    monkeypatch.setattr(ts, "apply_updates", no_update)


def _half_batch(monkeypatch):
    import repro_torch.train.train_step as ts
    loss_fn = ts.loss_fn

    def half(cfg, params, batch, mesh=None):
        n = batch["tokens"].shape[0] // 2
        return loss_fn(cfg, params, {k: v[:n] for k, v in batch.items()},
                       mesh=mesh)
    monkeypatch.setattr(ts, "loss_fn", half)


def _altered(monkeypatch):
    import repro_torch.train.train_step as ts
    apply_updates = ts.apply_updates

    def doubled(cfg, params, grads, state):
        ts.tree_leaves(grads)[0].mul_(2.0)
        return apply_updates(cfg, params, grads, state)
    monkeypatch.setattr(ts, "apply_updates", doubled)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", cells())
def test_a_broken_step_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = training.run(tiny_cell(name), 3_000_000_019, 0.01, False,
                       torch.device("cpu"), 0.0, log=lambda *a, **k: None)
    assert res["correct"] is False
    assert any(v > lim for v, lim in res["compared"].values())
