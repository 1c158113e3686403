"""Serving steps: batched greedy decode + prefill (the counterparts of
``repro.serve.serve_step``).

These run on the device under the engine's guard surface: the engine runs
each tick inside ``cluster.region(th, prefetch=...)``, fetches weights
through the colored ``StateCache`` and only then calls the step.  The
decode step writes the new k/v into the cache in place — the device
analogue of a ``WriteGuard``: an exclusive borrow of the owner's buffer,
local write + color bump at drop, no invalidation traffic to any replica.
"""

from __future__ import annotations

import torch

from repro_torch.models import decode_step, forward
from repro_torch.models.config import ModelConfig


def make_serve_step(cfg: ModelConfig, mesh=None):
    """serve_step(params, cache, tokens (B,1)) -> (next_tokens int32 (B,1),
    cache), the cache updated in place; ``mesh`` is passed on to
    ``decode_step``."""

    def serve_step(params, cache, tokens):
        logits, cache = decode_step(cfg, params, cache, tokens, mesh=mesh)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], cache

    return serve_step


def make_prefill(cfg: ModelConfig, mesh=None):
    """prefill(params, batch) -> (last_logits, per-position logits)."""

    def prefill(params, batch):
        logits, _ = forward(cfg, params, batch, mesh=mesh)
        return logits[:, -1, :], logits

    return prefill
