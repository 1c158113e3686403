"""Deterministic synthetic LM data (the counterpart of
``repro.train.data``): Markov-chain token streams, so that the loss
actually falls in the example runs, from the same numpy generator calls as
the reference, so that one seed gives the same batches in both packages.
"""

from __future__ import annotations

import numpy as np
import torch


def synthetic_batches(vocab: int, global_batch: int, seq_len: int,
                      seed: int = 0, prefix_len: int = 0, d_model: int = 0,
                      dtype="bfloat16"):
    """Infinite iterator of {"tokens", "labels"[, "prefix_embeds"]} numpy
    arrays.  numpy has no bfloat16: for ``dtype="bfloat16"`` the prefix
    embeddings stay float32 (the same draws; the model casts them)."""
    rng = np.random.default_rng(seed)
    # sparse Markov transition: each symbol prefers ~8 successors
    succ = rng.integers(0, vocab, size=(vocab, 8))
    while True:
        toks = np.empty((global_batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, size=global_batch)
        choice = rng.integers(0, 8, size=(global_batch, seq_len))
        for t in range(seq_len):
            toks[:, t + 1] = succ[toks[:, t], choice[:, t]]
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if prefix_len:
            pre = rng.standard_normal((global_batch, prefix_len, d_model))
            batch["prefix_embeds"] = pre.astype(
                np.float32 if dtype == "bfloat16" else dtype)
        yield batch


def shard_batch(mesh, batch, device="cuda"):
    """A host batch as tensors on ``device``.  Placing it over a mesh of
    devices waits for the multi-device slice (ROADMAP Queue 1 item 10)."""
    if mesh is not None:
        raise NotImplementedError(
            "shard_batch over a mesh: multi-device support is ROADMAP "
            "Queue 1 item 10")
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
