"""RWKV6 "Finch" (arXiv:2404.05892) in PyTorch, the counterpart of
``repro.models.rwkv``: attention-free time-mix with data-dependent decay,
plus squared-ReLU channel-mix.

The WKV6 recurrence per head (state S: M x M, float32)

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

runs in ``kernels.ops.rwkv_scan`` for every T: on the card that is the
chunked CUDA kernel K4 (chunk ``CHUNK``, from the cached state), prefill and
decode alike; on the CPU, or with ``cfg.attn_impl == "plain"``, the plain
step-by-step recurrence.  The decay is LoRA-produced as in Finch and
bounded per step (|log w| <= ``DECAY_SCALE``), so that the chunk form's
exponents stay in float32 range.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import normal, rms_norm, use_kernels
from repro_torch.kernels import ops, ref

CHUNK = 64                       # K4's chunk (csrc/rwkv_scan.cu kC)
LORA_R = 32
DECAY_SCALE = 0.105


def rwkv_params(cfg: ModelConfig, gen: torch.Generator, dtype, device):
    d, ff = cfg.d_model, cfg.d_ff
    M = cfg.rwkv_head_dim
    H = d // M
    s = d ** -0.5
    f32 = torch.float32
    return {
        # time-mix
        "mu": normal(gen, (5, d), dtype, device) * 0.02,   # r,k,v,w,g shifts
        "wr": normal(gen, (d, d), dtype, device) * s,
        "wk": normal(gen, (d, d), dtype, device) * s,
        "wv": normal(gen, (d, d), dtype, device) * s,
        "wg": normal(gen, (d, d), dtype, device) * s,
        "wo": normal(gen, (d, d), dtype, device) * s,
        "w0": normal(gen, (d,), f32, device) * 0.5,
        "w_lora_a": normal(gen, (d, LORA_R), dtype, device) * s,
        "w_lora_b": normal(gen, (LORA_R, d), dtype, device) * LORA_R ** -0.5,
        "u": normal(gen, (H, M), f32, device) * 0.1,
        "ln_x": torch.zeros((d,), dtype=dtype, device=device),
        # channel-mix
        "mu_c": normal(gen, (2, d), dtype, device) * 0.02,
        "ck": normal(gen, (d, ff), dtype, device) * s,
        "cv": normal(gen, (ff, d), dtype, device) * ff ** -0.5,
        "cr": normal(gen, (d, d), dtype, device) * s,
    }


def _token_shift(x, last):
    """shift(x)_t = x_{t-1}; position 0 takes ``last`` (B, D)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def time_mix(cfg: ModelConfig, p, x, state):
    """x: (B,T,D); state: {"S": (B,H,M,M) f32, "last": (B,D)} or None
    (zeros).  Returns (out, {"S", "last"})."""
    B, T, D = x.shape
    M = cfg.rwkv_head_dim
    H = D // M
    if state is None:
        S0, last = None, torch.zeros((B, D), dtype=x.dtype, device=x.device)
    else:
        S0, last = state["S"], state["last"]
    prev = _token_shift(x, last)
    mix = x[None] + p["mu"][:, None, None, :] * (prev - x)[None]  # (5,B,T,D)
    xr, xk, xv, xw, xg = mix.unbind(0)

    def heads(y):                # (B,T,D) -> (B,H,T,M), a view
        return y.reshape(B, T, H, M).transpose(1, 2)

    r, k, v = heads(xr @ p["wr"]), heads(xk @ p["wk"]), heads(xv @ p["wv"])
    g = F.silu(xg @ p["wg"])
    lora = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    logw = -DECAY_SCALE * torch.sigmoid(p["w0"][None, None, :]
                                        + lora.float())       # (B,T,D) <= 0
    scan = ops.rwkv_scan if use_kernels(cfg, x) else ref.rwkv_scan
    o, S = scan(r, k, v, heads(logw), p["u"], S0)
    o = o.transpose(1, 2).reshape(B, T, D).to(x.dtype)
    o = rms_norm(o, p["ln_x"], cfg.norm_eps) * g
    return o @ p["wo"], {"S": S, "last": x[:, -1, :]}


def channel_mix(cfg: ModelConfig, p, x, state):
    """Squared-ReLU channel mix with token shift."""
    last = state["last_c"] if state is not None else torch.zeros(
        (x.shape[0], x.shape[2]), dtype=x.dtype, device=x.device)
    prev = _token_shift(x, last)
    mix = x[None] + p["mu_c"][:, None, None, :] * (prev - x)[None]
    xk, xr = mix.unbind(0)
    kk = torch.square(torch.relu(xk @ p["ck"]))
    out = torch.sigmoid(xr @ p["cr"]) * (kk @ p["cv"])
    return out, {"last_c": x[:, -1, :]}
