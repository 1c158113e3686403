"""Optimizers in PyTorch: AdamW (configurable moment dtype) and Adafactor
(factored second moment, relative step clipping), the counterparts of
``repro.train.optimizer``.

``apply_updates`` writes the new parameters and optimizer state into the
given tensors, under ``torch.no_grad()``, and returns the same trees: the
in-place update is the port's counterpart of the reference's donated
buffers.  The arithmetic is the reference's, step for step in float32, so
one update from the same parameters and gradients gives the same numbers.
The clipped float32 gradient and the update's temporaries exist for one
leaf at a time, and Adafactor's are updated in place where that gives the
same numbers, so the largest leaf's float32 copies bound the optimizer's
peak memory (a full-size model's bf16 gradients are not copied to float32
all at once).
The step count, the learning rate and the gradient norm stay 0-d tensors
on the parameters' device, so a step never waits on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.torchstate import tree_leaves, tree_map


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


def _adamw(cfg: OptConfig, p, g, m, v, lr, bc1, bc2) -> None:
    m2 = cfg.b1 * m.float() + (1 - cfg.b1) * g
    v2 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
    step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
    step = step + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * step)
    m.copy_(m2)
    v.copy_(v2)


def _adafactor(cfg: OptConfig, p, g, vr, vc, lr, decay) -> None:
    """One Adafactor step of leaf ``p`` (the gradient ``g`` float32,
    clipped); ``g`` is consumed.  In place where the numbers are the same
    as the out-of-place formula's, so at most two float32 copies of the
    leaf are alive at once."""
    f = _factored_dims(p.shape)
    g2 = (g * g).add_(1e-30)
    if f is None:
        v2 = decay * vr + (1 - decay) * g2
        del g2
        precond = torch.rsqrt(v2 + cfg.eps).mul_(g)
        vr.copy_(v2)
    else:
        r, c = f
        vr.copy_(decay * vr + (1 - decay) * g2.mean(dim=c, keepdim=True))
        vc.copy_(decay * vc + (1 - decay) * g2.mean(dim=r, keepdim=True))
        del g2
        precond = (vr * vc).div_(torch.clamp(vr.mean(dim=r, keepdim=True),
                                             min=1e-30))
        precond.add_(cfg.eps).rsqrt_().mul_(g)
    del g
    # relative step clipping (RMS of update <= 1)
    rms = torch.sqrt(torch.mean(torch.square(precond)) + 1e-30)
    precond.div_(torch.clamp(rms, min=1.0))
    # p - lr (precond + wd p), p in float32, one float32 copy at a time
    precond.add_(p.to(torch.float32, copy=True).mul_(cfg.weight_decay))
    precond.mul_(lr)
    p.copy_(p.to(torch.float32, copy=True).sub_(precond))


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, state):
    """One optimizer step, written into ``params`` and ``state`` in place.
    Returns (params, state, {"grad_norm", "lr"}) with the same trees.  Each
    gradient is clipped by the global norm (``clip_by_global_norm``'s
    arithmetic) as its leaf is updated."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    state["count"] += 1
    count = state["count"].to(torch.float32)
    lr = schedule(cfg, count)
    if cfg.name == "adamw":
        bc1 = 1 - cfg.b1 ** count
        bc2 = 1 - cfg.b2 ** count
        for p, g, m, v in _zip(params, grads, state["mu"], state["nu"]):
            _adamw(cfg, p, g.float() * scale, m, v, lr, bc1, bc2)
    else:
        decay = 1.0 - count ** -0.8
        for p, g, vr, vc in _zip(params, grads, state["vr"], state["vc"]):
            _adafactor(cfg, p, g.float() * scale, vr, vc, lr, decay)
    return params, state, {"grad_norm": gnorm, "lr": lr}
