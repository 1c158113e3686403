"""Serving driver: batched decode with the ownership-paged KV cache, on the
card (the counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        [--full] [--layers N] [--device cuda] [--requests 12] [--slots 4] \\
        [--max-new 16] [--refresh-every 8] [--cluster 4 --wire int8] \\
        [--profile 8]

``--arch`` is any configuration of ``configs``: the dense, vlm and audio
ones, ``qwen3-moe-235b-a22b`` and ``arctic-480b`` (MoE), ``rwkv6-3b`` and
``recurrentgemma-9b``.  ``--full`` serves the published configuration
(``configs.get``) instead of its reduced ``smoke()`` variant, and
``--layers N`` cuts the depth to N layers at the same widths (an MoE
config does not fit one 80 GB card whole: qwen3-moe-235b-a22b runs with
``--full --layers 3``); the cut is printed.  Weights are random, from a seeded
``torch.Generator``.  ``--device`` defaults to ``cuda`` and raises without
a card.  On the card, attention, the experts' matmuls and the RWKV6 /
RG-LRU recurrences run in the hand-written CUDA kernels.
``--profile N`` traces N ticks after the first with ``torch.profiler`` and
prints the operators by device time, the tick's spans (``admit``,
``read_pages``, ``decode``) and the device's busy share of the window.

Demonstrates the paper's coherence protocol in the serving path:
  * shared prompt prefixes are immutably-borrowed pages (refcounted);
  * each decode step appends under a mutable borrow (color bump);
  * weight refresh is a colored-cache fetch: a writer (simulated online
    trainer) bumps the weights' color and every replica refetches lazily —
    zero invalidation messages.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true",
                    help="the published config, not its smoke() variant")
    ap.add_argument("--layers", type=int, default=0, metavar="N",
                    help="cut the config's depth to N layers")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--cluster", type=int, default=0,
                    help="serve on a simulated DSM cluster of N servers "
                    "(0: the local plane)")
    ap.add_argument("--wire", default="raw", choices=("raw", "int8"))
    ap.add_argument("--refresh-every", type=int, default=0,
                    help="bump weight color every N engine steps "
                    "(simulated online trainer)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace N ticks after the first with torch.profiler")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import configs
    from repro_torch.core import Cluster
    from repro_torch.core.torchstate import OwnedState
    from repro_torch.models import init_params
    from repro_torch.models.transformer import resolve_device
    from repro_torch.serve import ServeEngine
    from .trace import profiled

    cfg = configs.get(args.arch) if args.full else configs.smoke(args.arch)
    if args.layers:
        print(json.dumps({"arch": cfg.name, "reduced": {
            "n_layers": [cfg.n_layers, args.layers]}}))
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dev = resolve_device(args.device)
    gen = torch.Generator(dev if dev.type == "cuda" else "cpu")
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    weights = OwnedState("weights", params)
    cluster = Cluster(args.cluster, backend="drust") if args.cluster else None
    engine = ServeEngine(cfg, weights, slots=args.slots,
                         max_len=args.max_len, cluster=cluster,
                         wire=args.wire, device=dev)

    rng = np.random.default_rng(0)
    shared_prefix = list(rng.integers(0, cfg.vocab, size=cfg.attn_chunk))
    reqs = []
    for i in range(args.requests):
        # half the requests share a prompt prefix (page-level sharing)
        prompt = shared_prefix + list(rng.integers(0, cfg.vocab, size=8)) \
            if i % 2 == 0 else list(rng.integers(0, cfg.vocab, size=12))
        reqs.append(engine.submit(prompt, max_new=args.max_new))

    step, ticks = 0, []
    while engine.queue or engine.active:
        if args.profile and step == 1:
            step += profiled(engine.step, args.profile, dev,
                             more=lambda: engine.queue or engine.active)
            continue
        t0 = time.perf_counter()
        engine.step()
        ticks.append((time.perf_counter() - t0) * 1e3)
        step += 1
        if args.refresh_every and step % args.refresh_every == 0:
            with weights.borrow_mut() as ref:      # online weight update
                ref.set(ref.deref_mut())
        if step > 10_000:
            raise RuntimeError("engine did not drain")

    done = sum(1 for r in reqs if r.done)
    st = engine.stats()
    print(f"served {done}/{len(reqs)} requests in {st['steps']} steps "
          f"on {dev}; median tick {statistics.median(ticks):.3f} ms "
          f"(host clock, untraced ticks)")
    print(f"kv pages: {st['kv']}")
    print(f"weight refreshes: {st['weight_refreshes']} "
          f"(hits {st['weight_hits']}) — zero invalidation messages")
    if done != len(reqs):
        raise RuntimeError(f"only {done}/{len(reqs)} requests finished")
    return st


if __name__ == "__main__":
    main()
