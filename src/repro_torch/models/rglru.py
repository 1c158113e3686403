"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427) in
PyTorch, the counterpart of ``repro.models.rglru``:

    r_t = sigmoid(W_a x_t)            (recurrence gate)
    i_t = sigmoid(W_x x_t)            (input gate)
    a_t = exp(-c · softplus(Lambda) · r_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t^2) ⊙ (i_t ⊙ x_t)

The block follows the Griffin layout: input/gate linear pair, short causal
depthwise conv on the input branch, RG-LRU, GeLU-gated output projection.
The diagonal recurrence runs in ``kernels.ops.rglru_scan`` for every T,
with the cached h0 folded into the first step (b_0 += a_0 h0): on the card
that is the CUDA kernel K5, prefill and decode alike; on the CPU, or with
``cfg.attn_impl == "plain"``, the plain step-by-step loop.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import normal, use_kernels
from repro_torch.kernels import ops, ref

C_CONST = 8.0
CONV_W = 4


def rglru_params(cfg: ModelConfig, gen: torch.Generator, dtype, device):
    d, dl = cfg.d_model, cfg.lru_d
    s = d ** -0.5
    return {
        "w_in": normal(gen, (d, dl), dtype, device) * s,
        "w_gate": normal(gen, (d, dl), dtype, device) * s,
        "conv": normal(gen, (CONV_W, dl), dtype, device) * 0.3,
        "wa": normal(gen, (dl, dl), dtype, device) * dl ** -0.5,
        "wx": normal(gen, (dl, dl), dtype, device) * dl ** -0.5,
        "lam": normal(gen, (dl,), torch.float32, device) * 0.5 + 2.0,
        "w_out": normal(gen, (dl, d), dtype, device) * dl ** -0.5,
    }


def _causal_conv(x, w, state):
    """Depthwise causal conv, width CONV_W.  state: (B, CONV_W-1, dl)."""
    hist = torch.cat([state, x], dim=1) if state is not None else \
        F.pad(x, (0, 0, CONV_W - 1, 0))
    T = x.shape[1]
    out = sum(hist[:, i:i + T, :] * w[i][None, None, :]
              for i in range(CONV_W))
    return out, hist[:, -(CONV_W - 1):, :]


def rglru_block(cfg: ModelConfig, p, x, state=None):
    """x: (B,T,D); state: {"h": (B,dl) f32, "conv": (B,3,dl)} or None.
    Returns (y, {"h", "conv"})."""
    u = x @ p["w_in"]                                      # (B,T,dl)
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")     # jax.nn.gelu's
    u, conv_state = _causal_conv(u, p["conv"],
                                 None if state is None else state["conv"])
    r = torch.sigmoid(u @ p["wa"]).float()
    i = torch.sigmoid(u @ p["wx"]).float()
    log_a = -C_CONST * F.softplus(p["lam"])[None, None, :] * r   # <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * i * u.float()
    if state is not None:                                  # fold h0 in
        b[:, 0] += a[:, 0] * state["h"].float()
    scan = ops.rglru_scan if use_kernels(cfg, x) else ref.rglru_scan
    hs = scan(a, b)
    y = (hs.to(x.dtype) * gate) @ p["w_out"]
    return y, {"h": hs[:, -1, :], "conv": conv_state}
