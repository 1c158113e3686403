"""Plain PyTorch versions of the kernels (the same math as
``repro.kernels.ref``).  The CPU tests use them, ``ops`` takes them for CPU
tensors, and ``chip_smoke.py`` holds each CUDA kernel against them on the
card."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _scores(q, k, causal: bool, window: int):
    """Scaled, masked float32 scores (B,Hkv,G,T,S) of q (B,H,T,hd) against
    k (B,Hkv,S,hd); masked entries are ``NEG_INF``."""
    B, H, T, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, T, hd).float() * hd ** -0.5
    s = torch.einsum("bkgth,bksh->bkgts", qg, k.float())
    if causal:
        mask = torch.ones(T, S, dtype=torch.bool, device=q.device).tril(S - T)
        if window:
            mask &= ~mask.tril(S - T - window)
        s = s.masked_fill(~mask, NEG_INF)
    return s


def attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,H,T,hd); k,v: (B,Hkv,S,hd) -> (B,H,T,hd).  The causal mask is
    bottom-right aligned: query i sees key j when j <= i + S - T, and with
    a ``window`` > 0 only when also j > i + S - T - window."""
    return attention_lse(q, k, v, causal=causal, window=window)[0]


def attention_lse(q, k, v, *, causal: bool = True, window: int = 0):
    """``attention`` and the logsumexp of each query row's scaled, masked
    scores: (out (B,H,T,hd) in q.dtype, lse (B,H,T) float32), the ``lse``
    K2's forward writes for its backward."""
    B, H, T, hd = q.shape
    s = _scores(q, k, causal, window)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bksh->bkgth", p, v.float())
    return (o.reshape(B, H, T, hd).to(q.dtype),
            torch.logsumexp(s, dim=-1).reshape(B, H, T))


def attention_backward(q, k, v, out, lse, dout, *, causal: bool = True,
                       window: int = 0):
    """The gradients of ``attention`` by the explicit formula K2's backward
    computes, in float32: P = exp(scores - lse), D = rowsum(dout * out),
    dS = P * (dout v^T - D), dq = scale dS k, dk = scale dS^T q and
    dv = P^T dout, dk and dv summed over each group of G = H / Hkv query
    heads.  Returns (dq (B,H,T,hd), dk, dv (B,Hkv,S,hd)) in the inputs'
    dtype."""
    B, H, T, hd = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = hd ** -0.5
    s = _scores(q, k, causal, window)
    p = torch.exp(s - lse.float().reshape(B, Hkv, G, T, 1))
    qf = q.float().reshape(B, Hkv, G, T, hd)
    do = dout.float().reshape(B, Hkv, G, T, hd)
    D = (do * out.float().reshape(B, Hkv, G, T, hd)).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bkgth,bksh->bkgts", do, v.float()) - D)
    dq = torch.einsum("bkgts,bksh->bkgth", ds, k.float()) * scale
    dk = torch.einsum("bkgts,bkgth->bksh", ds, qf) * scale
    dv = torch.einsum("bkgts,bkgth->bksh", p, do)
    return (dq.reshape(B, H, T, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def moe_gmm(x, w, rows=None):
    """x: (E,C,D); w: (E,D,F) -> (E,C,F): the products in float32, cast
    to x.dtype.  With ``rows`` (E,) int, rows c >= rows[e] are zeros."""
    y = torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
    if rows is None:
        return y
    live = torch.arange(x.shape[1], device=x.device)[None, :] < rows[:, None]
    return torch.where(live[..., None], y, 0)


def rwkv_scan(r, k, v, logw, u, S0=None):
    """The WKV6 recurrence step by step, from ``S0`` (zeros if None):
        o_t = r_t (S + diag(u) k_t v_t^T);  S = diag(exp(logw_t)) S + k_t v_t^T
    r,k,v,logw: (B,H,T,M); u: (H,M); S0: (B,H,M,M) -> (o (B,H,T,M) f32,
    S (B,H,M,M) f32)."""
    B, H, T, M = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(logw.float())
    uf = u.float()[None, :, :, None]
    S = torch.zeros((B, H, M, M), dtype=torch.float32, device=r.device) \
        if S0 is None else S0.float()
    os = []
    for t in range(T):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        os.append(torch.einsum("bhm,bhmn->bhn", rf[:, :, t], S + uf * kv))
        S = w[:, :, t, :, None] * S + kv
    return torch.stack(os, dim=2), S


def rglru_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, step by step.  a, b: (B,T,D)
    -> (B,T,D) f32."""
    af, bf = a.float(), b.float()
    h = torch.zeros_like(af[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)
