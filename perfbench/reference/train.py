"""The reference's first training steps and the readings ``correct``
compares: each step's loss, each leaf's gradient at the first step as the
optimizer gets it (clipped), and each leaf's change over the steps.

A configuration's ``reference`` names its model's module,
``reference/<name>.py``, found by name: ``loss(cfg, prec, params, tokens,
labels)`` and ``model_flops(model, B, T)`` (the step's model FLOPs that
``metrics/train_mfu.py`` reads)."""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch

from perfbench import spec, weights
from . import optim
from .common import float32_matmuls

HERE = Path(__file__).resolve().parent


def module(name: str):
    """The reference module ``reference/<name>.py``."""
    path = HERE / f"{name}.py"
    spec.check_name(name, f"reference (file {path})")
    if not path.is_file():
        raise FileNotFoundError(f"no reference module {path}")
    mod_spec = importlib.util.spec_from_file_location(
        f"{__package__}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def model(config: dict):
    """The module of the configuration's ``reference``."""
    return module(config["reference"])


def leaf_norms(tensors: dict) -> dict:
    """{path: the L2 norm over every layer's tensor} in float64."""
    return {k: math.sqrt(sum(float(t.double().square().sum()) for t in ts))
            for k, ts in tensors.items()}


def _rounder(store: str | None):
    """How the parameters that the configuration keeps in bfloat16 are
    stored after each update: in float32 (None) or rounded to bfloat16
    (``"bf16"``, as the program stores them)."""
    if store is None:
        return None
    if store == "bf16":
        return lambda t: t.to(torch.bfloat16).float()
    raise ValueError(f"unknown storage {store!r}")


def train(config: dict, seed: int, batches: list, device, prec: str = "f32",
          store: str | None = None, rows=None) -> dict:
    """Run ``len(batches)`` steps from the seed's weights, the products
    in ``prec`` and the parameters stored as ``store`` says (``_rounder``;
    the control takes fp8 products and bf16 storage, as the program
    stores them).  ``rows`` keeps only those batch rows (a planted
    fault).  Returns {"loss": [per step], "grad": {path: clipped norm at
    step 1}, "grad_raw": {path: unclipped norm at step 1}, "rows": {path:
    ``weights.row_means_sq`` of the clipped gradient at step 1},
    "change": {path: norm}}."""
    cfg, opt = config["model"], config["optimizer"]
    mod = model(config)
    params = weights.reference_params(config, seed, device)
    for ts in params.values():
        for t in ts:
            t.requires_grad_(True)
    state = optim.init_state(opt, params)
    rounder = _rounder(store)
    out = {"loss": []}
    with float32_matmuls():
        for i, b in enumerate(batches, start=1):
            tokens, labels = b["tokens"], b["labels"]
            if rows is not None:
                tokens, labels = tokens[rows], labels[rows]
            loss = mod.loss(cfg, prec, params, tokens, labels)
            loss.backward()
            out["loss"].append(float(loss.detach()))
            grads = {k: [t.grad for t in ts] for k, ts in params.items()}
            scale, _ = optim.clip_scale(opt, grads)
            if i == 1:
                raw = leaf_norms(grads)
                out["grad_raw"] = raw
                out["grad"] = {k: v * scale for k, v in raw.items()}
                out["rows"] = weights.row_means_sq(grads, scale)
            optim.step(opt, params, grads, state, i, scale)
            if rounder is not None:
                with torch.no_grad():
                    for k, (dtype, _, _) in config["leaves"].items():
                        if dtype == "bfloat16":
                            for t in params[k]:
                                t.copy_(rounder(t))
            del grads
            for ts in params.values():
                for t in ts:
                    t.grad = None
    out["change"] = weights.change_norms(config, seed, params)
    return out
