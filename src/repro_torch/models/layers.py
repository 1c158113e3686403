"""Shared layers in PyTorch: RMSNorm, RoPE, GQA attention (chunked
online-softmax for long sequences), gated MLP — the counterparts of
``repro.models.layers``.

Layouts are the reference's:
  * attention projections:  wq (D, H, hd)   wk/wv (D, Hkv, hd)   wo (H, hd, D)
  * MLP:                    w_gate/w_up (D, F)   w_down (F, D)

On a CUDA tensor attention runs in the hand-written kernels
(``kernels.ops``): decode against the cache in ``decode_attention`` (K1),
prefill and forward in causal ``flash_attention`` (K2), with the sliding
window where the config has one.  The plain branches
of ``attention`` run for CPU tensors, or on the card when
``cfg.attn_impl == "plain"`` (the reference a kernel run is held against).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig
from repro_torch.kernels import ops

NEG_INF = -1e30


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x, positions, theta: float = 1e6):
    """x: (..., T, n, hd); positions: (..., T).  Half-split rotation with
    float32 angles."""
    hd = x.shape[-1]
    half = hd // 2
    # built on x's device from Python scalars: a table made on the host
    # and copied over would make every call wait for the device to drain
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    angles = positions[..., None].float() * freqs            # (..., T, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _mask_bias(q_pos, k_pos, window: int):
    """Causal (+ optional sliding-window) additive bias, (T, S) float32."""
    causal = k_pos[None, :] <= q_pos[:, None]
    if window:
        causal &= k_pos[None, :] > (q_pos[:, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=causal.device)
    return torch.where(causal, zero, NEG_INF)


def attention(q, k, v, q_pos, k_pos, *, window: int = 0, chunk: int = 1024):
    """Plain GQA attention.  q: (B,T,H,hd)  k,v: (B,S,Hkv,hd).

    Short sequences use one einsum; long sequences use an online-softmax
    loop over KV chunks so the score matrix never materializes."""
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = hd ** -0.5
    qg = q.reshape(B, T, Hkv, G, hd) * scale

    if S <= max(2 * chunk, 2048):
        scores = torch.einsum("btkgh,bskh->bktgs", qg, k).float()
        bias = _mask_bias(q_pos, k_pos, window)                   # (T, S)
        scores = scores + bias[None, None, :, None, :]
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bktgs,bskh->btkgh", probs, v)
        return out.reshape(B, T, H, hd)

    # flash-style: loop over KV chunks with running (max, sum, acc)
    if S % chunk:                         # pad to a chunk multiple (masked)
        pad = chunk - S % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.cat([k_pos, torch.full((pad,), 1 << 30,
                                             dtype=k_pos.dtype,
                                             device=k_pos.device)])
        S += pad
    m = torch.full((B, Hkv, T, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, T, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, T, G, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, S, chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = torch.einsum("btkgh,bskh->bktgs", qg, kc).float()
        s = s + _mask_bias(q_pos, k_pos[c0:c0 + chunk],
                           window)[None, None, :, None, :]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bktgs,bskh->bktgh", p.to(vc.dtype), vc).float()
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.transpose(1, 2).reshape(B, T, H, hd).to(q.dtype)


# The card's path.  q: (B,T,H,hd); k,v: (B,S,Hkv,hd), handed to the kernels
# as permuted views (never copied).
def _prefill_kernel(q, k, v, window: int):
    """Causal attention with q_pos == k_pos == arange(T): K2 with T == S,
    keys older than ``window`` dropped when it is > 0."""
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True, window=window)
    return out.transpose(1, 2)


def decode_kernel(q, kc, vc, length: int):
    """One token per row against the cache, valid below ``length``: K1."""
    B, T = q.shape[:2]
    if T != 1:
        raise NotImplementedError(
            "the CUDA decode path takes one token per step (the serving "
            "engine's shape); multi-token decode against a cache has no "
            "kernel yet")
    lens = torch.full((B,), length, dtype=torch.int32, device=q.device)
    out = ops.decode_attention(q[:, 0], kc.transpose(1, 2),
                               vc.transpose(1, 2), lens)
    return out[:, None]


# ---------------------------------------------------------------------------
#  Attention block (projections + rope + qk-norm + cache handling)
# ---------------------------------------------------------------------------
def attn_params(cfg: ModelConfig, gen: torch.Generator, dtype, device):
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = d ** -0.5
    p = {
        "wq": normal(gen, (d, H, hd), dtype, device) * s,
        "wk": normal(gen, (d, Hkv, hd), dtype, device) * s,
        "wv": normal(gen, (d, Hkv, hd), dtype, device) * s,
        "wo": normal(gen, (H, hd, d), dtype, device) * (H * hd) ** -0.5,
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


def project_qkv(cfg: ModelConfig, p, x, positions):
    """q (B,T,H,hd), k/v (B,T,Hkv,hd): projections, qk-norm and RoPE."""
    q = torch.einsum("btd,dnh->btnh", x, p["wq"])
    k = torch.einsum("btd,dnh->btnh", x, p["wk"])
    v = torch.einsum("btd,dnh->btnh", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta), \
        rope(k, positions, cfg.rope_theta), v


def use_kernels(cfg: ModelConfig, x) -> bool:
    """The card's path: CUDA tensors, unless the config asks for plain."""
    return x.is_cuda and cfg.attn_impl != "plain"


def attn_block(cfg: ModelConfig, p, x, positions, *, cache=None,
               window: int = 0):
    """x: (B,T,D); positions: (T,) int, shared across the batch.
    cache: dict(k/v: (B,S,Hkv,hd) views, length: int) for decode.  The new
    token's k/v are written into the cache in place (the reference's
    donated buffer).  A windowed decode goes through the ring cache
    (``transformer._attn_with_ring``) instead."""
    q, k, v = project_qkv(cfg, p, x, positions)
    kernels = use_kernels(cfg, x)

    if cache is None:
        if kernels:
            out = _prefill_kernel(q, k, v, window)
        else:
            out = attention(q, k, v, positions, positions, window=window,
                            chunk=cfg.attn_chunk)
    else:
        # decode: append the new token's k/v at `length`, attend to the
        # cache.  Like lax.dynamic_update_slice, the start clamps to S - T:
        # once length >= S the token lands at S-1 (RoPE keeps the unclamped
        # position) and every cache entry is valid.
        length = cache["length"]
        kc, vc = cache["k"], cache["v"]
        S, T = kc.shape[1], q.shape[1]
        start = max(0, min(length, S - T))
        kc[:, start:start + T] = k
        vc[:, start:start + T] = v
        cache = {"k": kc, "v": vc, "length": length + T}
        if kernels:
            if window:
                raise NotImplementedError("windowed decode on the card goes "
                                          "through the ring cache")
            out = decode_kernel(q, kc, vc, min(length + T, S))
        else:
            k_pos = torch.arange(S, device=x.device)
            # entries beyond `length` are masked by the causal bias
            out = attention(q, kc, vc, positions, k_pos, window=window,
                            chunk=cfg.attn_chunk)
    y = torch.einsum("btnh,nhd->btd", out, p["wo"])
    return y, cache


# ---------------------------------------------------------------------------
#  Gated MLP
# ---------------------------------------------------------------------------
def mlp_params(cfg: ModelConfig, gen: torch.Generator, dtype, device,
               d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": normal(gen, (d, f), dtype, device) * d ** -0.5,
        "w_up": normal(gen, (d, f), dtype, device) * d ** -0.5,
        "w_down": normal(gen, (f, d), dtype, device) * f ** -0.5,
    }


def mlp_block(cfg: ModelConfig, p, x):
    g = torch.einsum("btd,df->btf", x, p["w_gate"])
    u = torch.einsum("btd,df->btf", x, p["w_up"])
    if cfg.act == "geglu":
        h = F.gelu(g, approximate="tanh") * u      # jax.nn.gelu's default
    else:
        h = F.silu(g) * u
    return torch.einsum("btf,fd->btd", h, p["w_down"])


def normal(gen: torch.Generator, shape, dtype, device):
    """Standard normal draws from ``gen`` (a generator on ``device``; any
    generator for the shape-only ``meta`` device)."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)
