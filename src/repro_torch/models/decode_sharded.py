"""Sharded-sequence decode attention (the counterpart of
``repro.models.decode_sharded``).

The attention cache stays local: each rank holds its shard
``(B / dp, S / n_model, Hkv, hd)`` of every k/v leaf (a ``DTensor`` made by
``transformer.init_cache(..., mesh=)``), computes a *partial* online
softmax over its S slice for its batch rows, and the ``model`` ranks
combine the ``(B, H)``-sized statistics (one max and two sums) instead of
gathering the cache.  The new token's k/v are written only by the rank
that holds slot ``length``.

The partial softmax is plain PyTorch on every device, as the reference
computes it in XLA einsums: the decode kernel (K1) returns only the
normalised output, not the max and sum the ranks must combine.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import data_axes, mesh_coord, mesh_shape
from . import layers as L
from .config import ModelConfig


def shards_cache(mesh, B: int, S: int) -> bool:
    """Whether a (B, S, ...) cache splits over the mesh: B over the data
    dims and S over ``model``; else decode falls back to ``attn_block`` on
    a replicated cache, as the reference does."""
    n_dp = coll.rank_in(mesh, data_axes(mesh))[1]
    return S % mesh_shape(mesh)["model"] == 0 and B % n_dp == 0


def attn_decode_sharded(cfg: ModelConfig, mesh, p, x, positions, cache,
                        length: int):
    """x: (B, T, D) replicated; cache k/v: (B, S, Hkv, hd) DTensors split
    (dp, model, -, -), or replicated tensors when ``shards_cache`` is false.
    Writes the new k/v into the cache in place and returns y (B, T, D)."""
    kc, vc = cache["k"], cache["v"]
    B = x.shape[0]
    S = kc.shape[1]
    if not shards_cache(mesh, B, S):
        # the reference's fall-back when the cache or batch do not divide
        y, _ = L.attn_block(cfg, p, x, positions,
                            cache={**cache, "length": length},
                            window=cfg.window)
        return y
    if not isinstance(kc, DTensor):
        raise ValueError("a decode_shard_s cache on a mesh holds DTensor "
                         "shards: make it with init_cache(..., mesh=mesh)")
    if x.shape[1] != 1:
        raise NotImplementedError("sharded decode takes one token per step")
    n_model = mesh_shape(mesh)["model"]
    S_loc = S // n_model
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // Hkv

    q, k, v = L.project_qkv(cfg, p, x, positions)
    bi, n_dp = coll.rank_in(mesh, data_axes(mesh))
    b = B // n_dp
    rows = slice(bi * b, (bi + 1) * b)
    q, k, v = q[rows], k[rows], v[rows]
    kl, vl = kc.to_local(), vc.to_local()            # (b, S_loc, Hkv, hd)
    base = mesh_coord(mesh, "model") * S_loc
    if base <= length < base + S_loc:                # this rank owns the slot
        kl[:, length - base] = k[:, 0]
        vl[:, length - base] = v[:, 0]

    qg = q.reshape(b, 1, Hkv, G, hd).float() * hd ** -0.5
    s = torch.einsum("bokgh,bskh->bkgs", qg, kl.float())      # (b,Hkv,G,S_loc)
    k_pos = base + torch.arange(S_loc, device=x.device)
    s = torch.where((k_pos <= length)[None, None, None, :], s, -1e30)
    m_loc = s.amax(dim=-1)
    pexp = torch.exp(s - m_loc[..., None])
    l_loc = pexp.sum(dim=-1)
    acc_loc = torch.einsum("bkgs,bskh->bkgh", pexp, vl.float())
    model = coll.groups(mesh, ("model",))
    m = coll.all_reduce(m_loc, model, dist.ReduceOp.MAX)
    corr = torch.exp(m_loc - m)
    l = coll.all_reduce(l_loc * corr, model)
    acc = coll.all_reduce(acc_loc * corr[..., None], model)
    out = (acc / torch.clamp_min(l, 1e-30)[..., None]).reshape(b, 1, H, hd)
    out = coll.exit_gather(out.to(q.dtype), 0,
                           coll.groups(mesh, data_axes(mesh)))
    return torch.einsum("btnh,nhd->btd", out, p["wo"])
