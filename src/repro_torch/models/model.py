"""Public model API: init / forward / loss / cache / decode + batch specs
(the counterpart of ``repro.models.model``)."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import telemetry
from . import transformer as T
from .config import ModelConfig
from .transformer import forward_hidden  # noqa: F401  (re-export)

init_params = T.init_params
init_cache = T.init_cache
forward = T.forward
decode_step = T.decode_step


def _nll_sum(x, labels, head):
    """Summed negative log-likelihood of ``labels`` (B,C) under the float32
    logits of ``x`` (B,C,D) @ ``head`` (D,V)."""
    logits = torch.einsum("bcd,dv->bcv", x, head).float()
    true = logits.gather(-1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - true).sum()


def loss_fn(cfg: ModelConfig, params, batch, mesh=None):
    """Causal-LM cross entropy in float32 (+ 0.01 x the MoE load-balance
    aux), on the text positions only when the batch has prefix embeddings.

    With ``cfg.chunked_ce = n`` the head matmul and CE run per sequence
    chunk, each under ``torch.utils.checkpoint``, so the (B,T,V) logits
    (bf16 and the float32 cast) never exist at once, in the backward
    either: each chunk's logits are recomputed there.  ``mesh`` is passed
    on to the forward."""
    labels = batch["labels"].long()
    prefix = cfg.prefix_len and "prefix_embeds" in batch
    if cfg.chunked_ce:
        x, aux = forward_hidden(cfg, params, batch, mesh=mesh)
        if prefix:
            x = x[:, -labels.shape[1]:, :]
        B, Tlen, _ = x.shape
        n = cfg.chunked_ce
        if Tlen % n:
            raise ValueError(f"chunked_ce={n} does not divide T={Tlen}")
        C = Tlen // n
        with telemetry.span("repro_torch/loss_head"):
            head = T._head(cfg, params)
            total = sum(checkpoint(_nll_sum, x[:, i * C:(i + 1) * C],
                                   labels[:, i * C:(i + 1) * C], head,
                                   use_reentrant=False) for i in range(n))
        return total / (B * Tlen) + 0.01 * aux

    x, aux = forward_hidden(cfg, params, batch, mesh=mesh)
    with telemetry.span("repro_torch/loss_head"):
        logits = torch.einsum("btd,dv->btv", x, T._head(cfg, params))
        if prefix:
            logits = logits[:, -labels.shape[1]:, :]   # text positions only
        logits = logits.float()
        true = logits.gather(-1, labels[..., None])[..., 0]
        nll = (torch.logsumexp(logits, dim=-1) - true).mean()
    return nll + 0.01 * aux


def build_batch_spec(cfg: ModelConfig, global_batch: int, seq_len: int,
                     mode: str = "train"):
    """Stand-ins for every model input (the dry-run's): tensors on the
    ``meta`` device, of the reference's shapes and dtypes.  ``tokens``
    (B, T) int32, with ``labels`` for train and ``prefix_embeds`` (B, P, D)
    in the model's dtype where ``cfg.prefix_len`` is set; decode takes one
    new token a row against a cache of ``seq_len``: tokens (B, 1)."""
    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if mode in ("train", "prefill"):
        out = {"tokens": spec((global_batch, seq_len), torch.int32)}
        if mode == "train":
            out["labels"] = spec((global_batch, seq_len), torch.int32)
        if cfg.prefix_len:
            out["prefix_embeds"] = spec(
                (global_batch, cfg.prefix_len, cfg.d_model),
                getattr(torch, cfg.dtype))
        return out
    return {"tokens": spec((global_batch, 1), torch.int32)}
