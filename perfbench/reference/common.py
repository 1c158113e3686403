"""Layers shared by the reference models, in float32, and the precision
they compute in: ``"f32"``, or ``"fp8"`` for the control, which takes
every matrix product as fp8 training does: both operands rounded to
float8 e4m3 in the forward, the output's gradient to float8 e5m2 in the
backward (one scale a tensor, its largest magnitude at the format's
largest), the products of the rounded values taken in float32."""

from __future__ import annotations

import contextlib
import math

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def lm_leaf_shapes(m: dict) -> dict:
    """{path: one layer's shape} of the leaves every language model here
    has: the embedding, the final norm, the untied head, a layer's two
    norms."""
    d, V = m["d_model"], m["vocab"]
    out = {"embed": [V, d], "final_norm": [d]}
    if not m["tie_embeddings"]:
        out["lm_head"] = [d, V]
    out["layers.norm1"] = out["layers.norm2"] = [d]
    return out


@contextlib.contextmanager
def float32_matmuls():
    """TF32 off for matrix products and convolutions inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def round_fp8(x, dtype):
    """x rounded to the float8 ``dtype`` with one scale that puts its
    largest magnitude at the format's largest, back in x's dtype."""
    scale = x.abs().amax().clamp_min(1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(x.dtype) * scale


class _FP8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eq, a, b):
        qa = round_fp8(a, torch.float8_e4m3fn)
        qb = round_fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        ctx.eq = eq
        return torch.einsum(eq, qa, qb)

    @staticmethod
    def backward(ctx, grad):
        qa, qb = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = torch.einsum(ctx.eq, qa, qb)
        ga, gb = torch.autograd.grad(
            out, (qa, qb), round_fp8(grad, torch.float8_e5m2))
        return None, ga, gb


def mm(prec: str, eq: str, a, b):
    """``torch.einsum(eq, a, b)`` in the precision ``prec``."""
    if prec == "fp8":
        return _FP8Product.apply(eq, a, b)
    if prec != "f32":
        raise ValueError(f"unknown precision {prec!r}")
    return torch.einsum(eq, a, b)


def rms_norm(x, scale, eps: float):
    """x / rms(x) * (1 + scale): the zero-centred scale of Qwen3 and the
    port."""
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, positions, theta: float):
    """Half-split rotary embedding; x (B, T, n, hd), positions (T,)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend_rows(prec, q, k, v, t0: int):
    """Causal attention of the queries q (B, t, Hkv, G, hd), at positions
    t0.., over the keys k, v (B, S, Hkv, hd) with S = t0 + t."""
    t, S = q.shape[1], k.shape[1]
    s = mm(prec, "btkgh,bskh->bktgs", q, k)
    qpos = torch.arange(t0, t0 + t, device=q.device)
    kpos = torch.arange(S, device=q.device)
    bias = torch.where(kpos[None, :] <= qpos[:, None], 0.0, NEG_INF)
    p = torch.softmax(s + bias[None, None, :, None, :], dim=-1)
    return mm(prec, "bktgs,bskh->btkgh", p, v)


def causal_attention(prec, q, k, v, block: int = 512):
    """Causal GQA: q (B, T, H, hd), k, v (B, T, Hkv, hd) -> (B, T, H, hd).
    The queries go in blocks, each against the keys up to its last row
    and recomputed in the backward, so one block's scores exist at a
    time."""
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, H // Hkv, hd) * hd ** -0.5
    outs = []
    for t0 in range(0, T, block):
        t1 = min(T, t0 + block)
        outs.append(checkpoint(_attend_rows, prec, qg[:, t0:t1],
                               k[:, :t1], v[:, :t1], t0,
                               use_reentrant=False))
    return torch.cat(outs, dim=1).reshape(B, T, H, hd)


def _nll_rows(prec, x, head, labels):
    logits = mm(prec, "nd,dv->nv", x, head)
    true = logits.gather(-1, labels[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - true).sum()


def mean_nll(prec, x, head, labels, rows: int = 2048):
    """The mean cross entropy of ``labels`` (B, T) under x (B, T, D) @
    head (D, V), over blocks of ``rows`` tokens, each block's logits
    recomputed in the backward."""
    xf = x.reshape(-1, x.shape[-1])
    lf = labels.reshape(-1).long()
    total = sum(checkpoint(_nll_rows, prec, xf[i:i + rows], head,
                           lf[i:i + rows], use_reentrant=False)
                for i in range(0, xf.shape[0], rows))
    return total / xf.shape[0]
