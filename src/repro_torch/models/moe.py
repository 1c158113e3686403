"""Mixture-of-Experts block on one device: top-k token-choice routing with
capacity (the counterpart of ``repro.models.moe`` with
``axis_name=None``).

Dispatch is sort-free, as in the reference: each expert takes its top-C
tokens by router score (capacity drop like GShard).  The reference walks
the experts one by one; here all E are gathered at once into the
``(E, C, D)`` capacity buffers and the expert MLP runs as three grouped
matmuls over them (gate, up, down): ``moe_gmm`` (K3) on the card, its plain
version on the CPU or with ``attn_impl="plain"``.  Each expert's kept
tokens fill the first slots of its buffer (``topk`` sorts, and a dropped or
empty slot scores -inf), so the matmuls are told each expert's kept count
(``rows``) and skip the weights of experts that received no token; the
slots past it are zeros, which the reference's ``keep`` mask makes of them
anyway.  The output is summed over experts in float32 and cast once, so
the bf16 result does not depend on the order of ``index_add_``'s atomics.

The expert-parallel paths (``moe_shardmap``, ``moe_a2a_block``) come with
the multi-device slice (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from .config import ModelConfig
from . import layers as L


def moe_params(cfg: ModelConfig, gen: torch.Generator, dtype, device):
    """router (D, E) float32, as the reference keeps it in a bf16 model;
    experts w_gate/w_up (E, D, F) and w_down (E, F, D) in ``dtype``."""
    d, f, E = cfg.d_model, cfg.e_ff, cfg.n_experts
    s = d ** -0.5
    return {
        "router": L.normal(gen, (d, E), torch.float32, device) * s,
        "w_gate": L.normal(gen, (E, d, f), dtype, device) * s,
        "w_up": L.normal(gen, (E, d, f), dtype, device) * s,
        "w_down": L.normal(gen, (E, f, d), dtype, device) * f ** -0.5,
    }


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = max(1, int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    c = -(-c // 4) * 4                                  # multiple of 4
    return min(n_tokens, c)


def _route(cfg: ModelConfig, p, xt):
    """Route the tokens xt (N, D) -> (aux_loss, g, idx, keep): each
    expert's top-C router scores g (E, C), -inf where no token fills the
    slot, their token ids idx (E, C) and keep = g > -inf, which holds on a
    prefix of each row."""
    N = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = torch.topk(probs, K, dim=-1)                # (N, K)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=0)                                       # (E,)
    ce = torch.zeros(E, dtype=torch.float32, device=xt.device).index_add_(
        0, top_ids.reshape(-1),
        torch.full((N * K,), 1.0 / (N * K), device=xt.device))
    aux = E * torch.sum(me * ce)

    # per-token score for each expert: router prob if chosen, else -inf
    assigned = torch.full((N, E), float("-inf"), device=xt.device)
    assigned.scatter_(1, top_ids, top_p)

    # every expert's top-C tokens at once: (E, C) gates and token ids
    C = _capacity(cfg, N)
    g, idx = torch.topk(assigned.T, C, dim=1)
    return aux, g, idx, g > float("-inf")


def moe_block(cfg: ModelConfig, p, x):
    """x: (B, T, D).  Returns (y (B, T, D), aux_loss)."""
    B, T, D = x.shape
    N = B * T
    E = cfg.n_experts
    xt = x.reshape(N, D)
    aux, g, idx, keep = _route(cfg, p, xt)
    C = idx.shape[1]
    gate = torch.where(keep, g, 0.0).to(x.dtype)
    rows = keep.sum(1, dtype=torch.int32)          # kept slots, on the device
    xe = xt[idx]                                                 # (E, C, D)
    gmm = ops.moe_gmm if L.use_kernels(cfg, x) else ref.moe_gmm
    h = F.silu(gmm(xe, p["w_gate"], rows)) * gmm(xe, p["w_up"], rows)
    out = gmm(h, p["w_down"], rows) * gate[..., None]            # (E, C, D)
    out = torch.where(keep[..., None], out, 0.0)
    y = torch.zeros((N, D), dtype=torch.float32, device=x.device)
    y.index_add_(0, idx.reshape(-1), out.reshape(E * C, D).float())
    return y.to(x.dtype).reshape(B, T, D), aux
