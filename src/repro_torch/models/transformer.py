"""Decoder assembly in PyTorch for every family: dense, vlm, audio, moe,
rwkv and rglru (the counterpart of ``repro.models.transformer``).

Layer recipes
  dense/vlm/audio : x += attn(norm(x));  x += mlp(norm(x))
  moe             : x += attn(norm(x));  x += moe(norm(x)) [+ dense residual]
  rwkv            : x += time_mix(norm(x));  x += channel_mix(norm(x))
  rglru           : blocks of ``attn_every`` layers — (attn_every-1)
                    recurrent + 1 local-attention — scanned; the remainder
                    is an unrolled tail.

Each attention layer has a kind, from its index i: windowed (keys in
(t - window, t], plain RoPE) or full (every earlier key, with YaRN's RoPE
where ``cfg.yarn_factor`` is set).  ``cfg.window`` alone makes every
attention layer windowed; with ``cfg.global_every`` as well every
``global_every``-th layer is full (``cfg.layer_window(i)``), and while the
profiler runs each such layer's attention is the span
``repro_torch/attn_window`` or ``repro_torch/attn_full``.  The stacked
leaves are the same for both kinds.

With ``cfg.scan_layers`` the layer leaves stay **stacked** as the
reference's ``vmap``-ed init leaves them: ``params["layers"]`` is one dict
of ``(n_steps, ...)`` leaves, or for a hybrid a list of ``attn_every`` such
dicts (one per position in the block), and the forward loops over views
``p[i]`` where the reference scans (``torch.unbind`` in the forward, so
the backward writes each stacked leaf's gradient once).
``params["tail"]`` is a list of per-layer dicts.  This keeps the int8
weight refresh identical: ``quantize_tree`` gives one scale per leaf.

Caches, stacked the same way, plus one scalar ``length`` (a Python int)
shared by every slot:
  attention (global) : k/v (B, S, Hkv, hd)
  attention (window) : ring k/v (B, W, Hkv, hd) + slot positions (W,)
                       (one kind for every layer: a model that mixes the
                       kinds has no cache, and ``init_cache`` and
                       ``decode_step`` raise on it)
  rwkv               : S (B, H, M, M) float32 + token-shift states
  rglru              : h (B, dl) float32 + conv state (B, 3, dl)
Decode writes every new entry and state into the cache in place — the
reference's donated buffer.

On a mesh (``mesh=``, a ``DeviceMesh``; see ``dist/sharding.py``) every
rank runs the same program on replicated tensors, and the reference's
explicit sharded regions split the work: the MoE goes through
``moe_shardmap``, and a ``decode_shard_s`` model decodes against a cache
whose attention k/v leaves are ``DTensor`` shards
(``decode_sharded.attn_decode_sharded``).  ``mesh=None`` falls back to the
process-wide mesh of ``dist.sharding.set_mesh``, as in the reference.
"""

from __future__ import annotations

from typing import Any

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch import telemetry
from repro_torch.core.torchstate import tree_map
from repro_torch.dist.collectives import rank_in
from repro_torch.dist.sharding import (current_mesh, data_axes, mesh_shape,
                                       shard_act)
from .config import ModelConfig
from . import decode_sharded as DS
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


def _unbind(tree) -> list:
    """Every layer of a stacked tree, with one ``torch.unbind`` per leaf.
    Its backward writes each leaf's layer gradients into the stack once,
    where ``_index`` per layer costs one zeroed full-stack tensor and one
    full-stack add per layer.  Views that take in-place writes (the decode
    cache) must come from ``_index``: autograd refuses in-place writes to
    an unbind's outputs."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _layer_plan(cfg: ModelConfig):
    """(n_scanned, tail_indices): homogeneous stacks scan everything;
    hybrids scan whole blocks of ``attn_every`` and unroll the rest."""
    if cfg.attn_every:
        n_scanned = cfg.n_layers // cfg.attn_every * cfg.attn_every
        return n_scanned, list(range(n_scanned, cfg.n_layers))
    return cfg.n_layers, []


def _scanned(cfg: ModelConfig, tree, *, unbind: bool = False) -> list:
    """The scanned layers of a params or cache tree, in execution order:
    views of the stacked leaves (the list itself when not scan_layers),
    taken with ``_unbind`` when ``unbind`` and with ``_index`` otherwise."""
    if not cfg.scan_layers:
        return list(tree)
    period = cfg.attn_every or 1
    groups = [tree] if period == 1 else tree
    n_steps = _layer_plan(cfg)[0] // period
    if not n_steps:
        return []
    if unbind:
        steps = [_unbind(g) for g in groups]
        return [steps[j][s] for s in range(n_steps) for j in range(period)]
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
def _attn_len(cfg: ModelConfig, max_len: int) -> int:
    """An attention cache's S: max_len (or the window, for a ring) rounded
    up to ``attn_chunk``."""
    S = min(max_len, cfg.window) if cfg.window else max_len
    return -(-S // cfg.attn_chunk) * cfg.attn_chunk


def _layer_cache(cfg: ModelConfig, i: int, B: int, max_len: int, lead,
                 device, split=(1, 1)):
    """Layer ``i``'s zeroed cache, every leaf with leading dims ``lead``;
    attention k/v hold the (B / split[0], S / split[1]) shard."""
    dtype = getattr(torch, cfg.dtype)

    def zeros(*shape, dt=dtype):
        return torch.zeros((*lead, *shape), dtype=dt, device=device)

    if cfg.family == "rwkv":
        M = cfg.rwkv_head_dim
        return {"S": zeros(B, cfg.d_model // M, M, M, dt=torch.float32),
                "last": zeros(B, cfg.d_model), "last_c": zeros(B, cfg.d_model)}
    if cfg._is_attn_layer(i):
        S = _attn_len(cfg, max_len)
        b, s = B // split[0], S // split[1]
        c = {"k": zeros(b, s, cfg.n_kv_heads, cfg.hd),
             "v": zeros(b, s, cfg.n_kv_heads, cfg.hd)}
        if cfg.window:
            # unfilled ring slots must fail the window mask: far-past
            c["slot_pos"] = torch.full((*lead, S), -(1 << 30),
                                       dtype=torch.int32, device=device)
        return c
    return {"h": zeros(B, cfg.lru_d, dt=torch.float32),
            "conv": zeros(B, RGLRU.CONV_W - 1, cfg.lru_d)}


def _no_mixed_cache(cfg: ModelConfig) -> None:
    if cfg.mixed_attn:
        raise NotImplementedError(
            f"{cfg.name} mixes windowed and full attention layers: decode "
            f"needs a ring cache for the windowed layers beside full caches "
            f"for every {cfg.global_every}th layer in one cache, which "
            f"init_cache does not make")


def init_cache(cfg: ModelConfig, batch: int, max_len: int | None = None, *,
               device="cuda", mesh=None):
    """Zeroed decode cache in the layout of ``init_params`` (see the module
    docstring), with attention caches S = max_len (or the window, for a
    ring) rounded up to ``attn_chunk``, and ``length`` 0.

    With ``mesh`` and ``cfg.decode_shard_s`` (and no window) each rank
    allocates only its shard of the attention k/v leaves, batch over the
    data dims and S over ``model``, as ``DTensor``s; when the batch or S do
    not divide, or otherwise, the cache is replicated.  A model that mixes
    windowed and full attention layers raises ``NotImplementedError``."""
    _no_mixed_cache(cfg)
    dev = resolve_device(device)
    max_len = max_len or cfg.max_target_len
    n_scanned, tail = _layer_plan(cfg)
    period = cfg.attn_every or 1
    shard = (mesh is not None and cfg.decode_shard_s and not cfg.window
             and DS.shards_cache(mesh, batch, _attn_len(cfg, max_len)))
    split = (1, 1)
    if shard:
        split = (rank_in(mesh, data_axes(mesh))[1],
                 mesh_shape(mesh)["model"])

    def make(i, lead):
        c = _layer_cache(cfg, i, batch, max_len, lead, dev, split)
        if shard and "k" in c:
            for key in ("k", "v"):
                c[key] = _as_shards(c[key], mesh, len(lead), split)
        return c

    if cfg.scan_layers:
        lead = (n_scanned // period,)
        groups = [make(j, lead) for j in range(period)]
        layers = groups[0] if period == 1 else groups
    else:
        layers = [make(i % period, ()) for i in range(n_scanned)]
    return {"layers": layers, "tail": [make(i, ()) for i in tail],
            "length": 0}


def _as_shards(local, mesh, n_lead: int, split):
    """A local (..., b, s, Hkv, hd) shard as the DTensor whose global
    batch dim (``n_lead``) is split ``split[0]`` ways over the data dims
    and S ``split[1]`` ways over ``model``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dp = data_axes(mesh)
    placements = [Shard(n_lead) if a in dp else
                  Shard(n_lead + 1) if a == "model" else Replicate()
                  for a in mesh.mesh_dim_names]
    glob = list(local.shape)
    glob[n_lead] *= split[0]
    glob[n_lead + 1] *= split[1]
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(glob),
                              stride=torch.empty(glob, device="meta")
                              .stride())


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
    q, k, v = L.project_qkv(cfg, p, x, positions, cfg.window)
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


def _block(cfg: ModelConfig, p, x, positions, cache, length, mesh=None,
           layer: int = 0):
    """One layer, the ``layer``-th in execution order.  cache=None for
    prefill/forward; else this layer's cache views, updated in place.
    Returns (x, the layer's MoE aux loss)."""
    mesh = mesh if mesh is not None else current_mesh()
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
    elif cache is not None and cfg.decode_shard_s and mesh is not None:
        y = DS.attn_decode_sharded(cfg, mesh, p["attn"], h, positions, cache,
                                   length)
    else:
        c = None if cache is None else {**cache, "length": length}
        window = cfg.layer_window(layer)
        kind = telemetry.NOOP if not cfg.mixed_attn else telemetry.span(
            "repro_torch/attn_window" if window else "repro_torch/attn_full")
        with kind:
            y, _ = L.attn_block(cfg, p["attn"], h, positions, cache=c,
                                window=window)
    x = shard_act(x + y, mesh)
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    aux = 0.0
    if not cfg.n_experts:
        y2 = L.mlp_block(cfg, p["mlp"], h2)
    else:
        if mesh is not None:
            y2, aux = MOE.moe_shardmap(cfg, mesh, p["moe"], h2)
        else:
            y2, aux = MOE.moe_block(cfg, p["moe"], h2)
        if cfg.dense_residual:
            y2 = y2 + L.mlp_block(cfg, p["mlp"], h2)
    return shard_act(x + y2, mesh), aux


def _head(cfg: ModelConfig, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
#  forward / decode
# ---------------------------------------------------------------------------
def forward(cfg: ModelConfig, params, batch, mesh=None):
    """Prefill forward.  batch: tokens (B,T) [+ prefix_embeds (B,P,D) for
    the VLM/audio stubs].  Returns (logits, aux_loss)."""
    x, aux_total = forward_hidden(cfg, params, batch, mesh=mesh)
    logits = torch.einsum("btd,dv->btv", x, _head(cfg, params))
    return logits, aux_total


def forward_hidden(cfg: ModelConfig, params, batch, mesh=None):
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
    x = shard_act(x, mesh)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = 0.0
    scanned = _scanned(cfg, params["layers"], unbind=True)
    for i, p_layer in enumerate(scanned):
        if remat:
            x, aux = checkpoint(_block, cfg, p_layer, x, positions, None,
                                None, mesh, i, use_reentrant=False)
        else:
            x, aux = _block(cfg, p_layer, x, positions, None, None, mesh, i)
        aux_total = aux_total + aux
    for i, p_layer in enumerate(params["tail"], start=len(scanned)):
        x, aux = _block(cfg, p_layer, x, positions, None, None, mesh, i)
        aux_total = aux_total + aux
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux_total


def decode_step(cfg: ModelConfig, params, cache, tokens, mesh=None):
    """One decode step.  tokens: (B,T).  Returns (logits (B,T,V), cache);
    the cache's entries and states are updated in place and the returned
    cache carries ``length + T``.  A model that mixes windowed and full
    attention layers raises ``NotImplementedError``."""
    _no_mixed_cache(cfg)
    length = cache["length"]
    x = params["embed"][tokens.long()]
    T = tokens.shape[1]
    positions = length + torch.arange(T, dtype=torch.int32, device=x.device)
    p_layers = _scanned(cfg, params["layers"]) + params["tail"]
    c_layers = _scanned(cfg, cache["layers"]) + cache["tail"]
    for p_layer, c_layer in zip(p_layers, c_layers, strict=True):
        x, _ = _block(cfg, p_layer, x, positions, c_layer, length, mesh)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("btd,dv->btv", x, _head(cfg, params))
    return logits, {"layers": cache["layers"], "tail": cache["tail"],
                    "length": length + T}


def clone_cache(cache):
    """A copy of a decode cache whose tensors share nothing with it."""
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, cache)
