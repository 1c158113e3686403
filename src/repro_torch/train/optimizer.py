"""Optimizers in PyTorch: AdamW (configurable moment dtype) and Adafactor
(factored second moment, relative step clipping), the counterparts of
``repro.train.optimizer``.

``apply_updates`` writes the new parameters and optimizer state into the
given tensors, under ``torch.no_grad()``, and returns the same trees: the
in-place update is the port's counterpart of the reference's donated
buffers.  The arithmetic is the reference's, step for step in float32, so
one update from the same parameters and gradients gives the same numbers.
Each optimizer runs in passes over each leaf (``kernels.ops.adamw_*`` and
``kernels.ops.adafactor_*``: hand-written kernels on the card,
``kernels/ref.py`` on the CPU), the first over every gradient before the
global norm is known.  AdamW takes two: the gradient's sum of squares,
then one fused pass that reads the parameter, the gradient and both
moments and writes the parameter and the moments.  Adafactor takes three:
the first gives the global norm and the row and column sums of g^2, with
the clip's scale^2 taken out of them; the second and third update the
state and the parameter.  On the card no float32 copy of a leaf is made;
on the CPU the plain passes copy one leaf at a time.
The step count, the learning rate and the gradient norm stay 0-d tensors
on the parameters' device, so a step never waits on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.torchstate import tree_leaves, tree_map
from repro_torch.kernels import ops


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"              # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    moment_dtype: str = "float32"    # bfloat16 halves optimizer memory
    warmup: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: OptConfig, step):
    """Linear warmup, then cosine decay to ``min_lr_frac``; ``step`` an int
    or a tensor -> a float32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(cfg.warmup, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup)
                       / max(cfg.decay_steps - cfg.warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _factored_dims(shape):
    """Adafactor factors the two largest trailing dims of >=2D leaves."""
    if len(shape) < 2:
        return None
    return len(shape) - 2, len(shape) - 1


def init_opt_state(cfg: OptConfig, params):
    """Zeroed optimizer state beside ``params`` (on each leaf's device):
    AdamW's ``mu``/``nu`` in ``moment_dtype``, or Adafactor's factored
    ``vr``/``vc`` in float32, and ``count`` (int32)."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    state = {"count": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.name == "adamw":
        mdt = getattr(torch, cfg.moment_dtype)
        for key in ("mu", "nu"):
            state[key] = tree_map(
                lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device),
                params)
        return state

    def reduced(p, keep_row: bool):
        f = _factored_dims(p.shape)
        if f is None:
            shape = list(p.shape) if keep_row else [1] * p.dim()
        else:
            shape = list(p.shape)
            shape[f[1] if keep_row else f[0]] = 1
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    state["vr"] = tree_map(lambda p: reduced(p, True), params)
    state["vc"] = tree_map(lambda p: reduced(p, False), params)
    return state


def global_norm(tree):
    """The L2 norm of every leaf together, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm):
    """(the leaves as float32, scaled so their global norm is at most
    ``max_norm``; the norm before scaling)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, tree), norm


def _zip(tree, *others) -> list[tuple]:
    """(leaf, the leaf of each of ``others`` at the same path) for every
    leaf of ``tree``, dict keys matched by name, as ``jax.tree.map``
    matches them."""
    if isinstance(tree, dict):
        return [z for k in tree
                for z in _zip(tree[k], *(o[k] for o in others))]
    if isinstance(tree, (list, tuple)):
        return [z for i, t in enumerate(tree)
                for z in _zip(t, *(o[i] for o in others))]
    return [(tree, *others)]


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, state):
    """One optimizer step, written into ``params`` and ``state`` in place.
    Returns (params, state, {"grad_norm", "lr"}) with the same trees.  Each
    gradient is clipped by the global norm (``clip_by_global_norm``'s
    arithmetic) as its leaf is updated; each optimizer takes the norm from
    its own first pass over the gradients (``global_norm``'s sum, leaf by
    leaf in the same order, for AdamW)."""
    if cfg.name == "adamw":
        # the kernels walk a leaf's storage in order: a gradient laid out
        # otherwise (a tied embedding's, its head product's transpose) is
        # copied once, in its own dtype
        grads = tree_map(lambda g: g.contiguous(), grads)
        gnorm = torch.sqrt(sum(ops.adamw_sumsq(g)
                               for g in tree_leaves(grads)))
    else:
        leaves = _zip(params, grads, state["vr"], state["vc"])
        stats = [ops.adafactor_stats(g) for _, g, _, _ in leaves]
        gnorm = torch.sqrt(sum(st[0] for st in stats))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    state["count"] += 1
    count = state["count"].to(torch.float32)
    lr = schedule(cfg, count)
    if cfg.name == "adamw":
        bc1 = 1 - cfg.b1 ** count
        bc2 = 1 - cfg.b2 ** count
        for p, g, m, v in _zip(params, grads, state["mu"], state["nu"]):
            ops.adamw_update(p, g, m, v, scale, lr, bc1, bc2, b1=cfg.b1,
                             b2=cfg.b2, eps=cfg.eps, wd=cfg.weight_decay)
    else:
        decay = 1.0 - count ** -0.8
        for (p, g, vr, vc), st in zip(leaves, stats):
            ops.adafactor_update(p, g, vr, vc, st, scale, decay, lr, cfg.eps,
                                 cfg.weight_decay)
    return params, state, {"grad_norm": gnorm, "lr": lr}
