"""Mellum2 decoder layers in float32: RMSNorm, GQA attention without
q/k norm, of one of two kinds by the layer's index, and the sparse MoE
block of ``qwen3.py`` (top-k routing over all experts, probabilities
renormalised over the k, each expert keeping its top-C tokens by gate;
the Switch load-balance loss) in every layer.

The kinds (``model``: ``window``, ``global_every``): every
``global_every``-th layer is full, causal over every earlier key, with
YaRN's rotary embedding; the others see the ``window`` keys up to their
own, (i - window, i], with plain rotary embedding.  Every layer is
recomputed in the backward, and so is each block of queries.

``cfg`` is the configuration file's ``model`` dict; a layer's weights
come as {"attn.wq": (D, H, hd), ...} float32 tensors."""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from perfbench import counts, weights
from perfbench.metrics import _swa
from .common import (NEG_INF, causal_attention, lm_leaf_shapes, mean_nll,
                     mm, rms_norm, rope)
from .qwen3 import moe


def is_full(cfg: dict, j: int) -> bool:
    """Layer j attends to every earlier key: the last of each period of
    ``global_every`` layers, or every layer of a model without a
    window."""
    g = cfg.get("global_every", 0)
    return not cfg.get("window") or (g > 0 and (j + 1) % g == 0)


# the turns over the original context that bound YaRN's blend: the
# paper's beta and alpha for LLaMA, which Mellum2 publishes as beta_fast
# and beta_slow
BETA_FAST, BETA_SLOW = 32, 1


def yarn_temperature(s: float) -> float:
    """sqrt(1/t) of the paper's section 3.4, 0.1 ln s + 1 for a context
    stretched s times: the factor on q and on k."""
    return 0.1 * math.log(s) + 1


def yarn_rope(cfg: dict, x, positions):
    """Rotary embedding with YaRN's frequencies (Peng et al., "YaRN:
    Efficient Context Window Extension of Large Language Models",
    arXiv:2309.00071, "NTK-by-parts" with the linear ramp over the
    dimension index of its released code).  Pair d turns at theta^(-2d/hd)
    a position, L (the original context) / its wavelength times over
    the original context; the pair at which that is r is
    hd ln(L / (2 pi r)) / (2 ln theta).  Pairs up to the one of beta_fast
    turns (floored) keep their frequency, pairs from the one of beta_slow
    turns (ceiled) take it over the factor s, and the pairs between blend
    the two linearly.  x (B, T, n, hd), positions (T,)."""
    hd = x.shape[-1]
    half = hd // 2
    theta, s, L = cfg["rope_theta"], cfg["yarn_factor"], \
        cfg["yarn_original_len"]

    def pair(turns: float) -> float:
        return hd * math.log(L / (2 * math.pi * turns)) \
            / (2 * math.log(theta))

    lo = max(math.floor(pair(BETA_FAST)), 0)
    hi = min(math.ceil(pair(BETA_SLOW)), hd - 1)
    d = torch.arange(half, dtype=torch.float64)
    interp = ((d - lo) / max(hi - lo, 1e-3)).clamp(0.0, 1.0)
    own = theta ** (-2.0 * d / hd)
    freqs = (own * (1.0 - interp) + own / s * interp).float().to(x.device)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend_window(prec, q, k, v, t0: int, k0: int, window: int):
    """Queries q (B, t, Hkv, G, hd) at positions t0.. against the keys k,
    v (B, S, Hkv, hd) at positions k0.., each query keeping the keys in
    (its position - window, its position]."""
    t, S = q.shape[1], k.shape[1]
    s = mm(prec, "btkgh,bskh->bktgs", q, k)
    qpos = torch.arange(t0, t0 + t, device=q.device)[:, None]
    kpos = torch.arange(k0, k0 + S, device=q.device)[None, :]
    keep = (kpos <= qpos) & (kpos > qpos - window)
    bias = torch.where(keep, 0.0, NEG_INF)
    p = torch.softmax(s + bias[None, None, :, None, :], dim=-1)
    return mm(prec, "bktgs,bskh->btkgh", p, v)


def window_attention(prec, q, k, v, window: int, block: int = 512):
    """Sliding-window GQA: q (B, T, H, hd), k, v (B, T, Hkv, hd) -> (B, T,
    H, hd).  Each block of queries goes against the keys its window
    reaches, recomputed in the backward."""
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, H // Hkv, hd) * hd ** -0.5
    outs = []
    for t0 in range(0, T, block):
        t1, k0 = min(T, t0 + block), max(0, t0 - window + 1)
        outs.append(checkpoint(_attend_window, prec, qg[:, t0:t1],
                               k[:, k0:t1], v[:, k0:t1], t0, k0, window,
                               use_reentrant=False))
    return torch.cat(outs, dim=1).reshape(B, T, H, hd)


def layer(cfg: dict, prec: str, p: dict, x, positions, full: bool):
    eps = cfg["norm_eps"]
    h = rms_norm(x, p["norm1"], eps)
    q = mm(prec, "btd,dnh->btnh", h, p["attn.wq"])
    k = mm(prec, "btd,dnh->btnh", h, p["attn.wk"])
    v = mm(prec, "btd,dnh->btnh", h, p["attn.wv"])
    if full and cfg.get("yarn_factor"):
        # YaRN's temperature: the logits over t, sqrt(1/t) on q and on k
        m = yarn_temperature(cfg["yarn_factor"])
        q = yarn_rope(cfg, q, positions) * m
        k = yarn_rope(cfg, k, positions) * m
    else:
        q = rope(q, positions, cfg["rope_theta"])
        k = rope(k, positions, cfg["rope_theta"])
    att = causal_attention(prec, q, k, v) if full else \
        window_attention(prec, q, k, v, cfg["window"])
    x = x + mm(prec, "btnh,nhd->btd", att, p["attn.wo"])
    y, aux = moe(cfg, prec, p, rms_norm(x, p["norm2"], eps))
    return x + y, aux


def loss(cfg: dict, prec: str, params: dict, tokens, labels):
    """Mean next-token cross entropy + ``aux_coef`` x the summed MoE
    load-balance loss.  ``params``: {path: [tensor a layer]}."""
    x = params["embed"][0][tokens.long()]
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux = torch.zeros((), device=x.device)
    for j in range(cfg["n_layers"]):
        p = weights.layer_params(params, "layers", j)
        x, a = checkpoint(layer, cfg, prec, p, x, positions,
                          is_full(cfg, j), use_reentrant=False)
        aux = aux + a
    x = rms_norm(x, params["final_norm"][0], cfg["norm_eps"])
    head = params["embed"][0].T if cfg["tie_embeddings"] \
        else params["lm_head"][0]
    return mean_nll(prec, x, head, labels) + cfg["aux_coef"] * aux


def model_flops(model: dict, B: int, T: int) -> int:
    """A training step's model FLOPs: 6 x matmul parameters x tokens, and
    for attention 12 x the layer's (query, key) pairs x H x hd a layer
    (a windowed layer's pairs from ``_swa.window_pairs``); recomputation
    is not counted."""
    pairs = sum(_swa.layer_pairs(model, T))
    return 6 * counts.matmul_params(model) * B * T \
        + 12 * B * pairs * model["n_heads"] * model["head_dim"]


def leaf_shapes(m: dict) -> dict:
    """{path: one layer's shape} of the parameter tree of ``m``."""
    out = lm_leaf_shapes(m)
    d, H, Hkv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    E, f = m["n_experts"], m["moe_d_ff"]
    out.update({"layers.attn.wq": [d, H, hd], "layers.attn.wk": [d, Hkv, hd],
                "layers.attn.wv": [d, Hkv, hd], "layers.attn.wo": [H, hd, d],
                "layers.moe.router": [d, E], "layers.moe.w_gate": [E, d, f],
                "layers.moe.w_up": [E, d, f], "layers.moe.w_down": [E, f, d]})
    return out
