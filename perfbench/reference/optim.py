"""AdamW and Adafactor in float32 over the reference's parameters
({path: [tensor a layer]}), with the port's stated recipe: the gradients
clipped to a global norm, linear warmup then cosine decay, decoupled
weight decay, and Adafactor's second moment factored over the two last
dims of each leaf as the port stacks it (layers first), its update
clipped to RMS 1 over the whole leaf.

Work goes a block at a time (``_blocks``), so no leaf-sized temporary
is made beside the parameters and gradients."""

from __future__ import annotations

import math

import torch

BLOCK = 1 << 26                    # elements of a temporary at most


def schedule(opt: dict, count: int) -> float:
    warm = min((count + 1) / max(opt["warmup"], 1), 1.0)
    prog = min(max((count - opt["warmup"])
                   / max(opt["decay_steps"] - opt["warmup"], 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * (opt["min_lr_frac"]
                               + (1 - opt["min_lr_frac"]) * cos)


def clip_scale(opt: dict, grads: dict) -> tuple[float, float]:
    """(the factor that brings the global norm to ``clip_norm`` at most,
    the global norm)."""
    norm = math.sqrt(sum(float(g.double().square().sum())
                         for gs in grads.values() for g in gs))
    return min(opt["clip_norm"] / max(norm, 1e-9), 1.0), norm


def _blocks(t, rows: int):
    """Views of ``t`` of ``rows`` first-dim rows each."""
    return list(torch.split(t, rows, dim=0)) if t.dim() else [t]


def _rows(t) -> int:
    """First-dim rows a block: about BLOCK elements."""
    if t.dim() == 0:
        return 1
    return max(1, BLOCK // max(t.numel() // t.shape[0], 1))


def init_state(opt: dict, params: dict) -> dict:
    if opt["name"] == "adamw":
        return {"mu": {k: [torch.zeros_like(p) for p in ps]
                       for k, ps in params.items()},
                "nu": {k: [torch.zeros_like(p) for p in ps]
                       for k, ps in params.items()}}
    state = {}
    for k, ps in params.items():
        units = _units(ps)
        state[k] = [(torch.zeros(u.shape[:-1] + (1,), device=u.device),
                     torch.zeros(u.shape[:-2] + (1, u.shape[-1]),
                                 device=u.device)) if u.dim() >= 2 else
                    (torch.zeros_like(u), None) for u in units]
    return state


def _units(ps: list):
    """The tensors Adafactor factors one by one: each layer's tensor of
    two dims or more; the layers of a 1-D leaf stacked (layers, d), as
    the port factors its stacked leaf; an unstacked 1-D leaf as it is."""
    if len(ps) > 1 and ps[0].dim() == 1:
        return [torch.stack(ps)]
    return ps


@torch.no_grad()
def step(opt: dict, params: dict, grads: dict, state: dict, count: int,
         scale: float) -> None:
    """One update of ``params`` in place from ``grads`` (clipped by
    ``scale`` here); ``count`` is the step number from 1."""
    lr = schedule(opt, count)
    if opt["name"] == "adamw":
        bc1 = 1 - opt["b1"] ** count
        bc2 = 1 - opt["b2"] ** count
        for k in params:
            for p, g, m, v in zip(params[k], grads[k], state["mu"][k],
                                  state["nu"][k]):
                n = _rows(p)
                for pb, gb, mb, vb in zip(*(_blocks(t, n)
                                            for t in (p, g, m, v))):
                    gb = gb * scale
                    mb.mul_(opt["b1"]).add_((1 - opt["b1"]) * gb)
                    vb.mul_(opt["b2"]).add_((1 - opt["b2"]) * gb * gb)
                    upd = (mb / bc1) / (torch.sqrt(vb / bc2) + opt["eps"])
                    pb.sub_(lr * (upd + opt["weight_decay"] * pb))
        return
    decay = 1.0 - count ** -0.8
    for k in params:
        ps, gs = params[k], grads[k]
        stacked_1d = len(ps) > 1 and ps[0].dim() == 1
        units_p = [torch.stack(ps)] if stacked_1d else ps
        units_g = [torch.stack(gs)] if stacked_1d else gs
        for u_g, (vr, vc) in zip(units_g, state[k]):
            _moments(u_g, vr, vc, decay, scale)
        # the update's RMS over the whole leaf, then the update
        sq, n = 0.0, 0
        for u_g, (vr, vc) in zip(units_g, state[k]):
            for _, pre in _preconds(opt, u_g, vr, vc, scale):
                sq += float(pre.double().square().sum())
                n += pre.numel()
        div = max(math.sqrt(sq / n + 1e-30), 1.0)
        for u_p, u_g, (vr, vc) in zip(units_p, units_g, state[k]):
            for rows, pre in _preconds(opt, u_g, vr, vc, scale):
                pb = u_p[rows]
                pb.sub_(lr * (pre / div + opt["weight_decay"] * pb))
        if stacked_1d:
            for j, p in enumerate(ps):
                p.copy_(units_p[0][j])


def _moments(g, vr, vc, decay, scale) -> None:
    """Adafactor's second moments moved by the squared gradient: whole
    for one dim, (R, 1) row and (1, C) column means for two, and block by
    block along the first dim for more (each block whole matrices)."""
    def g2_of(gb):
        gb = gb * scale
        return gb * gb + 1e-30

    if vc is None:
        vr.mul_(decay).add_((1 - decay) * g2_of(g))
        return
    n = _rows(g)
    if g.dim() >= 3:
        for gb, rb, cb in zip(_blocks(g, n), _blocks(vr, n),
                              _blocks(vc, n)):
            g2 = g2_of(gb)
            rb.mul_(decay).add_((1 - decay) * g2.mean(dim=-1, keepdim=True))
            cb.mul_(decay).add_((1 - decay) * g2.mean(dim=-2, keepdim=True))
        return
    cols = torch.zeros_like(vc)
    for gb, rb in zip(_blocks(g, n), _blocks(vr, n)):
        g2 = g2_of(gb)
        rb.mul_(decay).add_((1 - decay) * g2.mean(dim=-1, keepdim=True))
        cols += g2.sum(dim=0, keepdim=True)
    vc.mul_(decay).add_((1 - decay) * cols / g.shape[0])


def _preconds(opt, g, vr, vc, scale):
    """(rows, the preconditioned gradient of those rows) a block at a
    time, from the moments as they stand."""
    n = _rows(g)
    if vc is not None and g.dim() == 2:
        row_mean = torch.clamp(vr.mean(dim=0, keepdim=True), min=1e-30)
    for i, gb in enumerate(_blocks(g, n)):
        rows = slice(i * n, i * n + gb.shape[0])
        gb = gb * scale
        if vc is None:
            yield rows, gb * torch.rsqrt(vr[rows] + opt["eps"])
            continue
        rb = vr[rows]
        if g.dim() >= 3:
            cb = vc[rows]
            mean = torch.clamp(rb.mean(dim=-2, keepdim=True), min=1e-30)
        else:
            cb, mean = vc, row_mean
        yield rows, gb * torch.rsqrt(rb * cb / mean + opt["eps"])
