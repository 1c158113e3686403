"""The plain float32 reference against the port's CPU path at each
configuration's tiny size, and its parts against their definitions."""

from __future__ import annotations

import math

import pytest
import torch

from perfbench import training, weights
from perfbench.reference import optim, rwkv6
from perfbench_tiny import cells, tiny_cell


def test_wkv_chunks_equal_the_steps():
    g = torch.Generator().manual_seed(0)
    B, H, T, M = 2, 3, 150, 8
    r, k, v = (torch.randn(B, H, T, M, generator=g, dtype=torch.float64)
               for _ in range(3))
    logw = -0.105 * torch.rand(B, H, T, M, generator=g, dtype=torch.float64)
    u = torch.randn(H, M, generator=g, dtype=torch.float64)
    want = rwkv6.wkv_steps(r, k, v, logw, u)
    got = rwkv6.wkv(r, k, v, logw, u)
    assert torch.allclose(got, want, rtol=1e-10, atol=1e-10)


SHAPES = {"layers.a": (3, 5), "layers.b": (3, 4, 6), "layers.c": (3, 2, 4, 6),
          "x": (7,), "y": (5, 6)}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_equals_the_ports(name, monkeypatch):
    """Three steps of the reference's optimizer on per-layer tensors equal
    the port's on the stacked tree, blocks or not."""
    from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                             init_opt_state)
    opt = dict(name=name, lr=1e-2, b1=0.9, b2=0.95, eps=1e-8,
               weight_decay=0.01, clip_norm=1.0, moment_dtype="float32",
               warmup=2, decay_steps=50, min_lr_frac=0.1)
    monkeypatch.setattr(optim, "BLOCK", 16)
    g = torch.Generator().manual_seed(1)
    flat = {k: torch.randn(s, generator=g) for k, s in SHAPES.items()}
    tree = {"layers": {k[7:]: v.clone() for k, v in flat.items()
                       if k.startswith("layers.")},
            "x": flat["x"].clone(), "y": flat["y"].clone()}
    ref = {k: list(v.clone()) if k.startswith("layers.") else [v.clone()]
           for k, v in flat.items()}
    cfg = OptConfig(**opt)
    state = init_opt_state(cfg, tree)
    rstate = optim.init_state(opt, ref)
    for step in range(1, 4):
        grads = {k: torch.randn(s, generator=g) * 3 for k, s in SHAPES.items()}
        gtree = {"layers": {k[7:]: v for k, v in grads.items()
                            if k.startswith("layers.")},
                 "x": grads["x"], "y": grads["y"]}
        apply_updates(cfg, tree, gtree, state)
        rgrads = {k: list(v) if k.startswith("layers.") else [v]
                  for k, v in grads.items()}
        scale, _ = optim.clip_scale(opt, rgrads)
        optim.step(opt, ref, rgrads, rstate, step, scale)
        got = weights.flat_program(tree)
        for k, ts in ref.items():
            assert torch.allclose(torch.stack(ts) if k.startswith("layers.")
                                  else ts[0], got[k], rtol=1e-5,
                                  atol=1e-6), (step, k)


@pytest.mark.parametrize("name", cells())
def test_both_sides_get_the_same_weights(name):
    conf = tiny_cell(name).config
    prog = weights.layer_slices(conf, weights.program_params(
        conf, 2 ** 31 + 7, "cpu"))
    ref = weights.reference_params(conf, 2 ** 31 + 7, "cpu")
    assert set(prog) == set(ref)
    for k, ts in ref.items():
        assert torch.equal(torch.stack(prog[k]).float(), torch.stack(ts))
        assert torch.stack(prog[k]).float().abs().sum() > 0 \
            or "norm" in k or "ln_x" in k


@pytest.mark.parametrize("name", cells())
def test_reference_follows_the_port_on_the_cpu(name):
    """A whole run of the cell at the tiny size on the CPU, float32 on both
    sides: the program (the port's plain path) and the reference agree to
    float32 rounding, far inside the cell's limits."""
    cell = tiny_cell(name)
    res = training.run(cell, 9_876_543_210, 0.05, False,
                       torch.device("cpu"), 0.0, log=lambda *a, **k: None)
    assert res["correct"] and res["failed"] == 0
    for value, limit in res["compared"].values():
        assert math.isfinite(value) and value < 1e-4
