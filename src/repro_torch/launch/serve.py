"""Serving driver: batched decode with the ownership-paged KV cache, on the
card (the counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        [--full] [--device cuda] [--requests 12] [--slots 4] [--max-new 16] \\
        [--refresh-every 8] [--cluster 4 --wire int8] [--profile 8]

``--full`` serves the published configuration (``configs.get``) instead of
its reduced ``smoke()`` variant; weights are random, from a seeded
``torch.Generator``.  ``--device`` defaults to ``cuda`` and raises without
a card.  On the card, attention runs in the hand-written CUDA kernels.
``--profile N`` traces N ticks after the first with ``torch.profiler`` and
prints the operators by device time and the device's busy share of the
window.

Demonstrates the paper's coherence protocol in the serving path:
  * shared prompt prefixes are immutably-borrowed pages (refcounted);
  * each decode step appends under a mutable borrow (color bump);
  * weight refresh is a colored-cache fetch: a writer (simulated online
    trainer) bumps the weights' color and every replica refetches lazily —
    zero invalidation messages.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true",
                    help="the published config, not its smoke() variant")
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

    cfg = configs.get(args.arch) if args.full else configs.smoke(args.arch)
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
            step += _profiled_ticks(engine, args.profile, dev)
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


def _profiled_ticks(engine, n: int, dev) -> int:
    """Run up to ``n`` ticks under ``torch.profiler``; print the operators
    by device time and one JSON line with the window's wall time, the
    summed device time and the device's idle share.  Returns the ticks
    run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    done = 0
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        while done < n and (engine.queue or engine.active):
            engine.step()
            done += 1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device time is counted once, on the kernels themselves: an operator's
    # self device time repeats the time of the kernels it launched
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    print(events.table(sort_by="self_device_time_total"
                       if hasattr(events[0], "self_device_time_total")
                       else "self_cuda_time_total", row_limit=15))
    aten_events = sum(e.count for e in events if e.key.startswith("aten::"))
    print(json.dumps({"profile_ticks": done, "wall_ms": wall_ms,
                      "device_busy_ms": busy_ms,
                      "device_idle_share": 1 - busy_ms / wall_ms,
                      "kernel_launches": sum(e.count for e in kernels),
                      "aten_events": aten_events,
                      "top_kernels": [
                          {"name": e.key[:80], "device_ms": dev_us(e) / 1e3,
                           "count": e.count}
                          for e in sorted(kernels, key=dev_us,
                                          reverse=True)[:8]]}))
    return done


if __name__ == "__main__":
    main()
