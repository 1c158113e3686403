"""Decoder assembly in PyTorch for every family: dense, vlm, audio, moe,
rwkv and rglru (the counterpart of ``repro.models.transformer``).

Layer recipes
  dense/vlm/audio : x += attn(norm(x));  x += mlp(norm(x))
  moe             : x += attn(norm(x));  x += moe(norm(x)) [+ dense residual]
  rwkv            : x += time_mix(norm(x));  x += channel_mix(norm(x))
  rglru           : blocks of ``attn_every`` layers — (attn_every-1)
                    recurrent + 1 local-attention — scanned; the remainder
                    is an unrolled tail.

With ``cfg.scan_layers`` the layer leaves stay **stacked** as the
reference's ``vmap``-ed init leaves them: ``params["layers"]`` is one dict
of ``(n_steps, ...)`` leaves, or for a hybrid a list of ``attn_every`` such
dicts (one per position in the block), and the forward loops over views
``p[i]`` where the reference scans.  ``params["tail"]`` is a list of
per-layer dicts.  This keeps the int8 weight refresh identical:
``quantize_tree`` gives one scale per leaf.

Caches, stacked the same way, plus one scalar ``length`` (a Python int)
shared by every slot:
  attention (global) : k/v (B, S, Hkv, hd)
  attention (window) : ring k/v (B, W, Hkv, hd) + slot positions (W,)
  rwkv               : S (B, H, M, M) float32 + token-shift states
  rglru              : h (B, dl) float32 + conv state (B, 3, dl)
Decode writes every new entry and state into the cache in place — the
reference's donated buffer.
"""

from __future__ import annotations

from typing import Any

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.core.torchstate import tree_map
from .config import ModelConfig
from . import layers as L
from . import moe as MOE
from . import rglru as RGLRU
from . import rwkv as RWKV


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


def _layer_plan(cfg: ModelConfig):
    """(n_scanned, tail_indices): homogeneous stacks scan everything;
    hybrids scan whole blocks of ``attn_every`` and unroll the rest."""
    if cfg.attn_every:
        n_scanned = cfg.n_layers // cfg.attn_every * cfg.attn_every
        return n_scanned, list(range(n_scanned, cfg.n_layers))
    return cfg.n_layers, []


def _scanned(cfg: ModelConfig, tree) -> list:
    """The scanned layers of a params or cache tree, in execution order:
    views of the stacked leaves (the list itself when not scan_layers)."""
    if not cfg.scan_layers:
        return list(tree)
    period = cfg.attn_every or 1
    groups = [tree] if period == 1 else tree
    n_steps = _layer_plan(cfg)[0] // period
    return [_index(groups[j], s) for s in range(n_steps)
            for j in range(period)]


# ---------------------------------------------------------------------------
#  parameter init
# ---------------------------------------------------------------------------
def _layer_params(cfg: ModelConfig, gen: torch.Generator, i: int, dtype,
                  device):
    p = {"norm1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
         "norm2": torch.zeros((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.family == "rwkv":
        p.update(RWKV.rwkv_params(cfg, gen, dtype, device))
        return p
    if cfg._is_attn_layer(i):
        p["attn"] = L.attn_params(cfg, gen, dtype, device)
    else:
        p["rec"] = RGLRU.rglru_params(cfg, gen, dtype, device)
    if cfg.n_experts:
        p["moe"] = MOE.moe_params(cfg, gen, dtype, device)
        if cfg.dense_residual:
            p["mlp"] = L.mlp_params(cfg, gen, dtype, device)
    else:
        p["mlp"] = L.mlp_params(cfg, gen, dtype, device)
    return p


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                *, device="cuda") -> dict:
    """Random parameters at the reference's shapes, dtypes and scales on
    ``device``, drawn from ``generator`` (a generator on that device; seed
    0 if None).  The numbers differ from ``jax.random``'s: parity goes
    through ``convert.params_from_jax``.  ``device="meta"`` gives shapes
    and dtypes only."""
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
    n_scanned, tail = _layer_plan(cfg)
    period = cfg.attn_every or 1
    if cfg.scan_layers and n_scanned:
        steps = [[_layer_params(cfg, gen, j, dtype, dev)
                  for j in range(period)]
                 for _ in range(n_scanned // period)]
        groups = [_stack([s[j] for s in steps]) for j in range(period)]
        params["layers"] = groups[0] if period == 1 else groups
    else:
        params["layers"] = [_layer_params(cfg, gen, i, dtype, dev)
                            for i in range(n_scanned)]
    params["tail"] = [_layer_params(cfg, gen, i, dtype, dev) for i in tail]
    return params


# ---------------------------------------------------------------------------
#  caches
# ---------------------------------------------------------------------------
def _layer_cache(cfg: ModelConfig, i: int, B: int, max_len: int, lead,
                 device):
    """Layer ``i``'s zeroed cache, every leaf with leading dims ``lead``."""
    dtype = getattr(torch, cfg.dtype)

    def zeros(*shape, dt=dtype):
        return torch.zeros((*lead, *shape), dtype=dt, device=device)

    if cfg.family == "rwkv":
        M = cfg.rwkv_head_dim
        return {"S": zeros(B, cfg.d_model // M, M, M, dt=torch.float32),
                "last": zeros(B, cfg.d_model), "last_c": zeros(B, cfg.d_model)}
    if cfg._is_attn_layer(i):
        S = min(max_len, cfg.window) if cfg.window else max_len
        S = -(-S // cfg.attn_chunk) * cfg.attn_chunk
        c = {"k": zeros(B, S, cfg.n_kv_heads, cfg.hd),
             "v": zeros(B, S, cfg.n_kv_heads, cfg.hd)}
        if cfg.window:
            # unfilled ring slots must fail the window mask: far-past
            c["slot_pos"] = torch.full((*lead, S), -(1 << 30),
                                       dtype=torch.int32, device=device)
        return c
    return {"h": zeros(B, cfg.lru_d, dt=torch.float32),
            "conv": zeros(B, RGLRU.CONV_W - 1, cfg.lru_d)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int | None = None, *,
               device="cuda"):
    """Zeroed decode cache in the layout of ``init_params`` (see the module
    docstring), with attention caches S = max_len (or the window, for a
    ring) rounded up to ``attn_chunk``, and ``length`` 0."""
    dev = resolve_device(device)
    max_len = max_len or cfg.max_target_len
    n_scanned, tail = _layer_plan(cfg)
    period = cfg.attn_every or 1
    if cfg.scan_layers:
        lead = (n_scanned // period,)
        groups = [_layer_cache(cfg, j, batch, max_len, lead, dev)
                  for j in range(period)]
        layers = groups[0] if period == 1 else groups
    else:
        layers = [_layer_cache(cfg, i % period, batch, max_len, (), dev)
                  for i in range(n_scanned)]
    return {"layers": layers,
            "tail": [_layer_cache(cfg, i, batch, max_len, (), dev)
                     for i in tail],
            "length": 0}


# ---------------------------------------------------------------------------
#  blocks
# ---------------------------------------------------------------------------
def _store(cache, new) -> None:
    """Write a layer's new state into its cache views, in place."""
    for k, v in new.items():
        cache[k].copy_(v)


def _attn_with_ring(cfg: ModelConfig, p, x, positions, cache, length: int):
    """Windowed attention against the ring cache (B, W, ...) for decode.
    The new k/v land at slot ``length % W`` (clamped to W - T, like
    ``lax.dynamic_update_slice``) with their positions in ``slot_pos``."""
    q, k, v = L.project_qkv(cfg, p, x, positions)
    kc, vc, sp = cache["k"], cache["v"], cache["slot_pos"]
    W, T = kc.shape[1], x.shape[1]
    start = max(0, min(length % W, W - T))
    kc[:, start:start + T] = k
    vc[:, start:start + T] = v
    sp[start:start + T] = positions
    if L.use_kernels(cfg, x):
        # K1 sees no positions: the ring's min(length + T, W) filled slots
        # are exactly the window's keys only when the ring is no wider
        if W > cfg.window:
            raise NotImplementedError(
                f"ring of {W} slots wider than the window {cfg.window}: K1 "
                f"cannot apply the window mask")
        out = L.decode_kernel(q, kc, vc, min(length + T, W))
    else:
        out = L.attention(q, kc, vc, positions, sp, window=cfg.window,
                          chunk=cfg.attn_chunk)
    return torch.einsum("btnh,nhd->btd", out, p["wo"])


def _block(cfg: ModelConfig, p, x, positions, cache, length):
    """One layer.  cache=None for prefill/forward; else this layer's cache
    views, updated in place.  Returns (x, the layer's MoE aux loss)."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if cfg.family == "rwkv":
        y, st = RWKV.time_mix(cfg, p, h, cache)
        x = x + y
        h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
        y2, st2 = RWKV.channel_mix(cfg, p, h2, cache)
        if cache is not None:
            _store(cache, {**st, **st2})
        return x + y2, 0.0

    if "attn" not in p:
        y, st = RGLRU.rglru_block(cfg, p["rec"], h, cache)
        if cache is not None:
            _store(cache, st)
    elif cache is not None and cfg.window:
        y = _attn_with_ring(cfg, p["attn"], h, positions, cache, length)
    else:
        c = None if cache is None else {**cache, "length": length}
        y, _ = L.attn_block(cfg, p["attn"], h, positions, cache=c,
                            window=cfg.window)
    x = x + y
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    if not cfg.n_experts:
        return x + L.mlp_block(cfg, p["mlp"], h2), 0.0
    y2, aux = MOE.moe_block(cfg, p["moe"], h2)
    if cfg.dense_residual:
        y2 = y2 + L.mlp_block(cfg, p["mlp"], h2)
    return x + y2, aux


def _head(cfg: ModelConfig, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
#  forward / decode
# ---------------------------------------------------------------------------
def forward(cfg: ModelConfig, params, batch):
    """Prefill forward.  batch: tokens (B,T) [+ prefix_embeds (B,P,D) for
    the VLM/audio stubs].  Returns (logits, aux_loss)."""
    x, aux_total = forward_hidden(cfg, params, batch)
    logits = torch.einsum("btd,dv->btv", x, _head(cfg, params))
    return logits, aux_total


def forward_hidden(cfg: ModelConfig, params, batch):
    """Forward up to the final norm (no logits).  Returns (x, aux_total):
    the MoE aux loss summed over layers, 0.0 without experts.

    With ``cfg.remat`` and grad mode on, each scanned layer runs under
    ``torch.utils.checkpoint`` (non-reentrant), which keeps only the
    layer's input for the backward and recomputes the rest there: the
    reference's ``jax.checkpoint(..., nothing_saveable)``.  The unrolled
    tail runs without it, as in the reference."""
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()]
    if cfg.prefix_len and "prefix_embeds" in batch:
        x = torch.cat([batch["prefix_embeds"].to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = 0.0
    for p_layer in _scanned(cfg, params["layers"]):
        if remat:
            x, aux = checkpoint(_block, cfg, p_layer, x, positions, None,
                                None, use_reentrant=False)
        else:
            x, aux = _block(cfg, p_layer, x, positions, None, None)
        aux_total = aux_total + aux
    for p_layer in params["tail"]:
        x, aux = _block(cfg, p_layer, x, positions, None, None)
        aux_total = aux_total + aux
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux_total


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One decode step.  tokens: (B,T).  Returns (logits (B,T,V), cache);
    the cache's entries and states are updated in place and the returned
    cache carries ``length + T``."""
    length = cache["length"]
    x = params["embed"][tokens.long()]
    T = tokens.shape[1]
    positions = length + torch.arange(T, dtype=torch.int32, device=x.device)
    p_layers = _scanned(cfg, params["layers"]) + params["tail"]
    c_layers = _scanned(cfg, cache["layers"]) + cache["tail"]
    for p_layer, c_layer in zip(p_layers, c_layers, strict=True):
        x, _ = _block(cfg, p_layer, x, positions, c_layer, length)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("btd,dv->btv", x, _head(cfg, params))
    return logits, {"layers": cache["layers"], "tail": cache["tail"],
                    "length": length + T}


def clone_cache(cache):
    """A copy of a decode cache whose tensors share nothing with it."""
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, cache)
