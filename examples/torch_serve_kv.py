"""Serving example through the PyTorch port: batched decode with the
ownership-paged KV cache, prefix sharing across requests, zero-invalidation
online weight refresh — then the same engine DSM-backed on a simulated
4-server cluster under open-loop load (see docs/serving.md).

    PYTHONPATH=src python examples/torch_serve_kv.py [--device cpu]

The model (granite-34b's reduced same-family config, random weights from a
seeded ``torch.Generator``) runs on ``--device`` (default ``cuda``).
"""

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import Cluster
from repro_torch.core.torchstate import OwnedState
from repro_torch.models import init_params
from repro_torch.models.transformer import resolve_device
from repro_torch.serve import (OpenLoopDriver, ServeEngine, ServeFleet,
                               poisson_trace, synth_prompts)


def local_plane(dev, n_requests):
    cfg = configs.smoke("granite-34b")      # MQA: maximal KV read sharing
    gen = torch.Generator(dev if dev.type == "cuda" else "cpu")
    weights = OwnedState("weights",
                         init_params(cfg, gen.manual_seed(0), device=dev))
    engine = ServeEngine(cfg, weights, slots=4, max_len=256, device=dev)

    rng = np.random.default_rng(0)
    system_prompt = list(rng.integers(0, cfg.vocab, size=cfg.attn_chunk))
    for i in range(n_requests):
        user = list(rng.integers(0, cfg.vocab, size=6 + i % 5))
        engine.submit(system_prompt + user, max_new=12)

    ticks = 0
    while engine.queue or engine.active:
        engine.step()
        ticks += 1
        if ticks % 10 == 0:             # online trainer pushes new weights:
            # one write epoch — the color bump IS the invalidation, no
            # messages to any replica
            weights.write(weights.read())

    st = engine.stats()
    print(f"decode ticks on {dev}: {st['steps']}")
    print(f"kv cache: {st['kv']} — the shared system prompt is ONE page "
          f"retained by every request")
    print(f"weight refreshes {st['weight_refreshes']} vs zero-comm hits "
          f"{st['weight_hits']} (no invalidation messages, ever)\n")


def dsm_plane():
    # The same engine over the DSM runtime: pages are protocol objects
    # (appends = scoped write guards, prefix reads = batched immutable
    # borrows inside each tick's region), weights refresh in int8 over the
    # wire, and an open-loop Poisson trace supplies production-shaped load.
    cl = Cluster(4, backend="drust", ooo=True, qps_per_thread=2)
    weights = OwnedState("serve_w", {"w": np.ones((64, 64), np.float32)})

    def stub_step(params, cache, tokens):   # deterministic decode stand-in
        return (tokens * 7 + 3) % 256, cache

    fleet = ServeFleet(cl, step_fn=stub_step, page_size=8, slots=4,
                       max_len=64, weights=weights, wire="int8",
                       decode_cycles=390_000.0)    # ~150 us/tick at 2.6 GHz
    n = 48
    driver = OpenLoopDriver(fleet, poisson_trace(2500.0, n, seed=7),
                            synth_prompts(n, seed=7), max_new=8,
                            weight_push_every=8)
    driver.run()
    r = driver.result(slo_us=5000.0)
    st = fleet.stats()
    print(f"open-loop serve on 4 servers: {r.completed} requests, "
          f"p50 {r.p50_us:.0f} us, p99 {r.p99_us:.0f} us "
          f"(queueing included), goodput {r.goodput_tok_s:.0f} tok/s")
    print(f"protocol: {cl.sim.net.round_trips} round trips, "
          f"{st['wire_bytes']} int8 wire bytes over "
          f"{st['weight_refreshes']} weight refreshes, "
          f"kv hits/misses {st['kv']['hits']}/{st['kv']['misses']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=12,
                    help="requests of the local plane")
    args = ap.parse_args(argv)
    local_plane(resolve_device(args.device), args.requests)
    dsm_plane()


if __name__ == "__main__":
    main()
