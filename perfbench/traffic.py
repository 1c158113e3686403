"""The one generator of training traffic: batches of the synthetic Markov
stream, a copy of ``repro_torch.train.data.synthetic_batches`` (its
numpy draws in its order), seeded by ``--seed``.

A traffic file (``traffic/<name>.json``) gives ``batch``, ``seq_len`` and
``successors`` (each symbol's preferred successors).  Batch ``i`` of a
seed is the same whatever the number of batches drawn, so a run that
draws more batches draws the same first ones.
"""

from __future__ import annotations

import numpy as np


def markov_batches(vocab: int, batch: int, seq_len: int, n: int, seed: int,
                   successors: int = 8):
    """(tokens, labels): int32 arrays (n, batch, seq_len), batch i being
    the i-th batch ``synthetic_batches(vocab, batch, seq_len, seed)``
    yields."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(vocab, successors))
    starts, choices = [], []
    for _ in range(n):                    # the generator's draws, in order
        starts.append(rng.integers(0, vocab, size=batch))
        choices.append(rng.integers(0, successors, size=(batch, seq_len)))
    toks = np.empty((n * batch, seq_len + 1), np.int32)
    toks[:, 0] = np.concatenate(starts)
    choice = np.concatenate(choices)
    for t in range(seq_len):              # every row's walk at once
        toks[:, t + 1] = succ[toks[:, t], choice[:, t]]
    toks = toks.reshape(n, batch, seq_len + 1)
    return toks[:, :, :-1], toks[:, :, 1:]


def device_batches(traffic: dict, vocab: int, n: int, seed: int, device):
    """``n`` batches of ``traffic`` as {"tokens", "labels"} int32 tensors
    on ``device``, one copy to the device for all of them."""
    import torch
    tokens, labels = markov_batches(vocab, traffic["batch"],
                                    traffic["seq_len"], n, seed,
                                    traffic.get("successors", 8))
    both = torch.from_numpy(np.stack([tokens, labels])).to(device)
    return [{"tokens": both[0, i], "labels": both[1, i]} for i in range(n)]
