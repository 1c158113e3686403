"""Decoder assembly in PyTorch for the dense, vlm and audio families (the
counterpart of ``repro.models.transformer``).

Layer recipe: x += attn(norm(x)); x += mlp(norm(x)).

With ``cfg.scan_layers`` the layer leaves stay **stacked** with a leading
``n_layers`` dim, as the reference's ``vmap``-ed init leaves them, and the
forward loops over views ``p[i]`` where the reference scans.  This keeps the
int8 weight refresh identical: ``quantize_tree`` gives one scale per leaf.
The KV cache is stacked the same way: k/v ``(L, B, S, Hkv, hd)`` plus one
scalar ``length`` (a Python int) shared by every slot.  Decode writes the
new k/v into that cache in place — the reference's donated buffer.
"""

from __future__ import annotations

from typing import Any

import torch

from .config import ModelConfig
from . import layers as L

_LATER = {
    "moe": "the MoE family and its moe_gmm kernel (K3), ROADMAP Queue 1 "
           "item 6",
    "rwkv": "the RWKV6 family and its rwkv_scan kernel (K4), ROADMAP Queue 1 "
            "item 7",
    "rglru": "the RG-LRU family and its rglru_scan kernel (K5), ROADMAP "
             "Queue 1 item 8",
}


def _check_supported(cfg: ModelConfig) -> None:
    family = "moe" if cfg.n_experts else cfg.family
    if family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: family {family!r} is not ported yet; it comes with "
            f"{_LATER[family]}")
    if cfg.window:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window attention (ring cache) is not "
            f"ported yet; it comes with {_LATER['rglru']}")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``cuda`` without a card raises:
    there is no silent CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda."
                           "is_available() is False; pass device='cpu' to "
                           "run on the CPU")
    return dev


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree: views, no copies."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
#  parameter init
# ---------------------------------------------------------------------------
def _layer_params(cfg: ModelConfig, gen: torch.Generator, dtype, device):
    return {"norm1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "norm2": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "attn": L.attn_params(cfg, gen, dtype, device),
            "mlp": L.mlp_params(cfg, gen, dtype, device)}


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                *, device="cuda") -> dict:
    """Random parameters at the reference's shapes and scales on ``device``,
    drawn from ``generator`` (a generator on that device; seed 0 if None).
    The numbers differ from ``jax.random``'s: parity goes through
    ``convert.params_from_jax``.  ``device="meta"`` gives shapes only."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(dev if dev.type == "cuda" else "cpu")
        gen.manual_seed(0)
    dtype = getattr(torch, cfg.dtype)
    params: dict[str, Any] = {
        "embed": L.normal(gen, (cfg.vocab, cfg.d_model), dtype, dev) * 0.02,
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal(gen, (cfg.d_model, cfg.vocab), dtype,
                                     dev) * cfg.d_model ** -0.5
    layers = [_layer_params(cfg, gen, dtype, dev)
              for _ in range(cfg.n_layers)]
    params["layers"] = _stack(layers) if cfg.scan_layers else layers
    params["tail"] = []
    return params


# ---------------------------------------------------------------------------
#  caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int | None = None, *,
               device="cuda"):
    """Zeroed KV cache: k/v (L, B, S, Hkv, hd) with S = max_len rounded up
    to ``attn_chunk`` (a list of per-layer (B, S, Hkv, hd) dicts when not
    ``scan_layers``), and ``length`` 0."""
    _check_supported(cfg)
    dev = resolve_device(device)
    max_len = max_len or cfg.max_target_len
    S = -(-max_len // cfg.attn_chunk) * cfg.attn_chunk
    dtype = getattr(torch, cfg.dtype)
    shape = (batch, S, cfg.n_kv_heads, cfg.hd)
    if cfg.scan_layers:
        layers = {"k": torch.zeros((cfg.n_layers, *shape), dtype=dtype,
                                   device=dev),
                  "v": torch.zeros((cfg.n_layers, *shape), dtype=dtype,
                                   device=dev)}
    else:
        layers = [{"k": torch.zeros(shape, dtype=dtype, device=dev),
                   "v": torch.zeros(shape, dtype=dtype, device=dev)}
                  for _ in range(cfg.n_layers)]
    return {"layers": layers, "tail": [], "length": 0}


# ---------------------------------------------------------------------------
#  blocks
# ---------------------------------------------------------------------------
def _block(cfg: ModelConfig, p, x, positions, cache, length):
    """One layer.  cache=None for prefill/forward; else this layer's
    {"k", "v"} views, updated in place."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    c = None if cache is None else {**cache, "length": length}
    y, _ = L.attn_block(cfg, p["attn"], h, positions, cache=c,
                        window=cfg.window)
    x = x + y
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + L.mlp_block(cfg, p["mlp"], h2)


def _layers(cfg: ModelConfig, params):
    if cfg.scan_layers:
        return [_index(params["layers"], i) for i in range(cfg.n_layers)]
    return params["layers"]


def _head(cfg: ModelConfig, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
#  forward / decode
# ---------------------------------------------------------------------------
def forward(cfg: ModelConfig, params, batch):
    """Prefill forward.  batch: tokens (B,T) [+ prefix_embeds (B,P,D) for
    the VLM/audio stubs].  Returns (logits, aux_loss)."""
    x = forward_hidden(cfg, params, batch)
    logits = torch.einsum("btd,dv->btv", x, _head(cfg, params))
    return logits, 0.0


def forward_hidden(cfg: ModelConfig, params, batch):
    """Forward up to the final norm (no logits)."""
    _check_supported(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()]
    if cfg.prefix_len and "prefix_embeds" in batch:
        x = torch.cat([batch["prefix_embeds"].to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for p_layer in _layers(cfg, params):
        x = _block(cfg, p_layer, x, positions, None, None)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One decode step.  tokens: (B,T).  Returns (logits (B,T,V), cache);
    the cache's k/v are updated in place and the returned cache carries
    ``length + T``."""
    _check_supported(cfg)
    length = cache["length"]
    x = params["embed"][tokens.long()]
    T = tokens.shape[1]
    positions = length + torch.arange(T, dtype=torch.int32, device=x.device)
    if cfg.scan_layers:
        layer_caches = [_index(cache["layers"], i)
                        for i in range(cfg.n_layers)]
    else:
        layer_caches = cache["layers"]
    for p_layer, c_layer in zip(_layers(cfg, params), layer_caches):
        x = _block(cfg, p_layer, x, positions, c_layer, length)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("btd,dv->btv", x, _head(cfg, params))
    return logits, {"layers": cache["layers"], "tail": cache["tail"],
                    "length": length + T}
