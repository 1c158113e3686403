"""Qwen3 decoder layers in float32: RMSNorm, GQA attention with qk-norm
and RoPE, and either the gated SiLU MLP (dense) or the sparse MoE block
(top-k routing over all experts, probabilities renormalised over the k,
each expert keeping its top-C tokens by gate, C = the capacity; the
Switch load-balance loss).  Every layer is recomputed in the backward.

``cfg`` is the configuration file's ``model`` dict; a layer's weights
come as {"attn.wq": (D, H, hd), ...} float32 tensors."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import counts, weights
from .common import (causal_attention, lm_leaf_shapes, mean_nll, mm,
                     rms_norm, rope)


def capacity(cfg: dict, n_tokens: int) -> int:
    """Slots an expert keeps: n k cf / E, rounded up to a multiple of 4,
    at most n."""
    c = max(1, int(n_tokens * cfg["top_k"] * cfg["capacity_factor"]
                   / cfg["n_experts"]))
    return min(n_tokens, -(-c // 4) * 4)


def moe(cfg: dict, prec: str, p: dict, x):
    """x (B, T, D) -> (y, load-balance loss)."""
    B, T, D = x.shape
    N, E, K = B * T, cfg["n_experts"], cfg["top_k"]
    xt = x.reshape(N, D)
    probs = torch.softmax(mm(prec, "nd,de->ne", xt, p["moe.router"]), -1)
    top_p, top_ids = torch.topk(probs, K, dim=-1)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    share = torch.zeros(E, device=x.device).index_add_(
        0, top_ids.reshape(-1),
        torch.full((N * K,), 1.0 / (N * K), device=x.device))
    aux = E * torch.sum(probs.mean(dim=0) * share)

    score = torch.full((N, E), float("-inf"), device=x.device)
    score = score.scatter(1, top_ids, top_p)
    gate, idx = torch.topk(score.T, capacity(cfg, N), dim=1)   # (E, C)
    keep = gate > float("-inf")
    xe = xt[idx]                                                # (E, C, D)
    h = F.silu(mm(prec, "ecd,edf->ecf", xe, p["moe.w_gate"])) \
        * mm(prec, "ecd,edf->ecf", xe, p["moe.w_up"])
    out = mm(prec, "ecf,efd->ecd", h, p["moe.w_down"])
    gate = torch.where(keep, gate, 0.0)
    out = torch.where(keep[..., None], out * gate[..., None], 0.0)
    y = torch.zeros((N, D), device=x.device).index_add(
        0, idx.reshape(-1), out.reshape(-1, D))
    return y.reshape(B, T, D), aux


def mlp(prec: str, p: dict, x):
    g = mm(prec, "btd,df->btf", x, p["mlp.w_gate"])
    u = mm(prec, "btd,df->btf", x, p["mlp.w_up"])
    return mm(prec, "btf,fd->btd", F.silu(g) * u, p["mlp.w_down"])


def layer(cfg: dict, prec: str, p: dict, x, positions):
    eps = cfg["norm_eps"]
    h = rms_norm(x, p["norm1"], eps)
    q = mm(prec, "btd,dnh->btnh", h, p["attn.wq"])
    k = mm(prec, "btd,dnh->btnh", h, p["attn.wk"])
    v = mm(prec, "btd,dnh->btnh", h, p["attn.wv"])
    if cfg["qk_norm"]:
        q = rms_norm(q, p["attn.q_norm"], eps)
        k = rms_norm(k, p["attn.k_norm"], eps)
    q = rope(q, positions, cfg["rope_theta"])
    k = rope(k, positions, cfg["rope_theta"])
    att = causal_attention(prec, q, k, v)
    x = x + mm(prec, "btnh,nhd->btd", att, p["attn.wo"])
    h2 = rms_norm(x, p["norm2"], eps)
    if cfg.get("n_experts"):
        y, aux = moe(cfg, prec, p, h2)
    else:
        y, aux = mlp(prec, p, h2), torch.zeros((), device=x.device)
    return x + y, aux


def loss(cfg: dict, prec: str, params: dict, tokens, labels):
    """Mean next-token cross entropy (+ ``aux_coef`` x the summed MoE
    load-balance loss).  ``params``: {path: [tensor a layer]}."""
    embed = params["embed"][0]
    x = embed[tokens.long()]
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux = torch.zeros((), device=x.device)
    for j in range(cfg["n_layers"]):
        p = weights.layer_params(params, "layers", j)
        x, a = checkpoint(layer, cfg, prec, p, x, positions,
                          use_reentrant=False)
        aux = aux + a
    x = rms_norm(x, params["final_norm"][0], cfg["norm_eps"])
    head = embed.T if cfg["tie_embeddings"] else params["lm_head"][0]
    out = mean_nll(prec, x, head, labels)
    if cfg.get("n_experts"):
        out = out + cfg["aux_coef"] * aux
    return out


def model_flops(model: dict, B: int, T: int) -> int:
    """A training step's model FLOPs: the frozen count of ``counts``."""
    return counts.model_flops(model, B, T)


def leaf_shapes(m: dict) -> dict:
    """{path: one layer's shape} of the parameter tree of ``m``."""
    out = lm_leaf_shapes(m)
    d, H, Hkv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    out.update({"layers.attn.wq": [d, H, hd], "layers.attn.wk": [d, Hkv, hd],
                "layers.attn.wv": [d, Hkv, hd], "layers.attn.wo": [H, hd, d],
                "layers.attn.q_norm": [hd], "layers.attn.k_norm": [hd]})
    if m.get("n_experts"):
        E, f = m["n_experts"], m["moe_d_ff"]
        out.update({"layers.moe.router": [d, E],
                    "layers.moe.w_gate": [E, d, f],
                    "layers.moe.w_up": [E, d, f],
                    "layers.moe.w_down": [E, f, d]})
    else:
        f = m["d_ff"]
        out.update({"layers.mlp.w_gate": [d, f], "layers.mlp.w_up": [d, f],
                    "layers.mlp.w_down": [f, d]})
    return out
