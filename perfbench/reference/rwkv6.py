"""RWKV-6 "Finch" layers in float32 (arXiv:2404.05892), as the port
states them: token-shift mixes, r/k/v/g projections, the decay
log w = -scale sigmoid(w0 + tanh(x W_a) W_b) (bounded per step), the WKV
recurrence per head of M channels

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T,

an RMS norm of the heads' output gated by SiLU(g), and the squared-ReLU
channel mix.  The recurrence runs in closed form over chunks of 64
steps (``wkv``), which ``wkv_steps`` checks step by step in the tests.
Every layer is recomputed in the backward."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import counts, weights
from .common import lm_leaf_shapes, mean_nll, mm, rms_norm

CHUNK = 64


def wkv_steps(r, k, v, logw, u):
    """The recurrence one step at a time: r, k, v, logw (B, H, T, M), u
    (H, M) -> o (B, H, T, M), from a zero state."""
    B, H, T, M = r.shape
    S = torch.zeros((B, H, M, M), dtype=r.dtype, device=r.device)
    out = []
    for t in range(T):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        out.append(torch.einsum("bhm,bhmn->bhn", r[:, :, t],
                                S + u[None, :, :, None] * kv))
        S = torch.exp(logw[:, :, t])[..., None] * S + kv
    return torch.stack(out, dim=2)


def wkv(r, k, v, logw, u, chunk: int = CHUNK):
    """The same recurrence in closed form over chunks: within a chunk,
    with a_t the cumulative log decay, key s reaches query t > s scaled
    by exp(a_{t-1} - a_s); the state at each chunk's start carries the
    earlier chunks.  |log w| <= 0.105 keeps exp(+-a) in range."""
    B, H, T, M = r.shape
    n = -(-T // chunk)
    pad = n * chunk - T
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, pad)) for t in (r, k, v, logw))
    r, k, v, logw = (t.reshape(B, H, n, chunk, M) for t in (r, k, v, logw))
    a = torch.cumsum(logw, dim=3)                  # through step t
    a_prev = a - logw                              # through step t - 1
    rq = r * torch.exp(a_prev)
    kk = k * torch.exp(-a)
    lower = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=r.device).tril(-1)
    A = torch.where(lower, rq @ kk.transpose(-1, -2), 0.0)
    bonus = (r * u[None, :, None, None, :] * k).sum(-1, keepdim=True)
    o = A @ v + bonus * v
    a_last = a[:, :, :, -1:, :]                    # (B, H, n, 1, M)
    U = (k * torch.exp(a_last - a)).transpose(-1, -2) @ v    # (B,H,n,M,M)
    S = torch.zeros((B, H, M, M), dtype=r.dtype, device=r.device)
    starts = []
    for c in range(n):
        starts.append(S)
        S = torch.exp(a_last[:, :, c, 0, :])[..., None] * S + U[:, :, c]
    o = o + rq @ torch.stack(starts, dim=2)
    return o.reshape(B, H, n * chunk, M)[:, :, :T]


def _shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def time_mix(cfg: dict, prec: str, p: dict, x):
    B, T, D = x.shape
    M = cfg["rwkv_head_dim"]
    H = D // M
    mix = x[None] + p["mu"][:, None, None, :] * (_shift(x) - x)[None]
    xr, xk, xv, xw, xg = mix.unbind(0)

    def heads(y):
        return y.reshape(B, T, H, M).transpose(1, 2)

    r = heads(mm(prec, "btd,de->bte", xr, p["wr"]))
    k = heads(mm(prec, "btd,de->bte", xk, p["wk"]))
    v = heads(mm(prec, "btd,de->bte", xv, p["wv"]))
    g = F.silu(mm(prec, "btd,de->bte", xg, p["wg"]))
    lora = mm(prec, "btr,rd->btd",
              torch.tanh(mm(prec, "btd,dr->btr", xw, p["w_lora_a"])),
              p["w_lora_b"])
    logw = -cfg["decay_scale"] * torch.sigmoid(p["w0"] + lora)
    o = wkv(r, k, v, heads(logw), p["u"])
    o = o.transpose(1, 2).reshape(B, T, D)
    o = rms_norm(o, p["ln_x"], cfg["norm_eps"]) * g
    return mm(prec, "btd,de->bte", o, p["wo"])


def channel_mix(prec: str, p: dict, x):
    mix = x[None] + p["mu_c"][:, None, None, :] * (_shift(x) - x)[None]
    xk, xr = mix.unbind(0)
    kk = torch.square(torch.relu(mm(prec, "btd,df->btf", xk, p["ck"])))
    return torch.sigmoid(mm(prec, "btd,de->bte", xr, p["cr"])) \
        * mm(prec, "btf,fd->btd", kk, p["cv"])


def layer(cfg: dict, prec: str, p: dict, x):
    eps = cfg["norm_eps"]
    x = x + time_mix(cfg, prec, p, rms_norm(x, p["norm1"], eps))
    return x + channel_mix(prec, p, rms_norm(x, p["norm2"], eps))


def loss(cfg: dict, prec: str, params: dict, tokens, labels):
    """Mean next-token cross entropy.  ``params``: {path: [tensor a
    layer]}."""
    x = params["embed"][0][tokens.long()]
    for j in range(cfg["n_layers"]):
        p = weights.layer_params(params, "layers", j)
        x = checkpoint(layer, cfg, prec, p, x, use_reentrant=False)
    x = rms_norm(x, params["final_norm"][0], cfg["norm_eps"])
    head = params["embed"][0].T if cfg["tie_embeddings"] \
        else params["lm_head"][0]
    return mean_nll(prec, x, head, labels)


def model_flops(model: dict, B: int, T: int) -> int:
    """A training step's model FLOPs: the frozen count of ``counts``."""
    return counts.model_flops(model, B, T)


def leaf_shapes(m: dict) -> dict:
    """{path: one layer's shape} of the parameter tree of ``m``."""
    out = lm_leaf_shapes(m)
    d, M, r, f = m["d_model"], m["rwkv_head_dim"], m["lora_r"], m["d_ff"]
    out.update({"layers.mu": [5, d], "layers.w0": [d],
                "layers.w_lora_a": [d, r], "layers.w_lora_b": [r, d],
                "layers.u": [d // M, M], "layers.ln_x": [d],
                "layers.mu_c": [2, d], "layers.ck": [d, f],
                "layers.cv": [f, d]})
    for k in ("wr", "wk", "wv", "wg", "wo", "cr"):
        out[f"layers.{k}"] = [d, d]
    return out
