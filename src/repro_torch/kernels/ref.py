"""Plain PyTorch versions of the kernels (the same math as
``repro.kernels.ref``).  The CPU tests use them, ``ops`` takes them for CPU
tensors, and ``chip_smoke.py`` holds each CUDA kernel against them on the
card."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention(q, k, v, *, causal: bool = True):
    """q: (B,H,T,hd); k,v: (B,Hkv,S,hd) -> (B,H,T,hd).  The causal mask is
    bottom-right aligned: query i sees key j when j <= i + S - T."""
    B, H, T, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, T, hd).float() * hd ** -0.5
    s = torch.einsum("bkgth,bksh->bkgts", qg, k.float())
    if causal:
        mask = torch.ones(T, S, dtype=torch.bool, device=q.device).tril(S - T)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bksh->bkgth", p, v.float())
    return o.reshape(B, H, T, hd).to(q.dtype)


def decode_attention(q, k, v, lengths):
    """q: (B,H,hd); k,v: (B,Hkv,S,hd); lengths: (B,) -> (B,H,hd)."""
    B, H, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, hd).float() * hd ** -0.5
    s = torch.einsum("bkgh,bksh->bkgs", qg, k.float())
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksh->bkgh", p, v.float())
    return o.reshape(B, H, hd).to(q.dtype)
