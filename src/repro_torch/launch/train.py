"""End-to-end training driver, on the card (the counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        [--full] [--layers N] [--device cuda] [--steps 30] [--batch 8] \\
        [--seq 256] [--microbatches 1] [--ckpt-dir DIR] [--ckpt-every 10] \\
        [--fail-at N]   (inject a failure: restore from the epoch backup) \
        [--profile N]   (trace N steps after the first with torch.profiler)

Runs the real loop: synthetic data -> ownership-wrapped train state ->
step (in-place update, color bump per epoch) -> epoch-batched
checkpointing -> optional failure injection and recovery.  Without
``--full`` it trains the reduced ``smoke()`` config; ``--layers N`` cuts
the depth at the same widths.  Weights are random, from a seeded
``torch.Generator``.  ``--device`` defaults to ``cuda`` and raises without
a card; on the card attention and its gradient run in K2's kernels (an
architecture whose forward reaches another kernel raises: those have no
backward yet).
"""

from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--layers", type=int, default=0, metavar="N",
                    help="cut the config's depth to N layers")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace N steps after the first with torch.profiler")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.torchstate import tree_leaves
    from repro_torch.models import init_params
    from repro_torch.models.transformer import resolve_device
    from repro_torch.train import (OptConfig, TrainState, shard_batch,
                                   synthetic_batches)
    from .trace import profiled

    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    if args.layers:
        print(f"arch={cfg.name} reduced n_layers {cfg.n_layers} -> "
              f"{args.layers}")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dev = resolve_device(args.device)
    gen = torch.Generator(dev if dev.type == "cuda" else "cpu")
    params = init_params(cfg, gen.manual_seed(0), device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M "
          f"batch={args.batch}x{args.seq}")

    opt = OptConfig(lr=args.lr, warmup=5, decay_steps=args.steps * 2)
    ts = TrainState(cfg, opt, params, microbatches=args.microbatches)
    ts.replicate()                                # §4.2.3 backup slot
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, ts.state,
                                every_n_epochs=args.ckpt_every)

    data = synthetic_batches(cfg.vocab, args.batch, args.seq,
                             prefix_len=cfg.prefix_len, d_model=cfg.d_model)
    losses = []
    t0 = time.time()

    def one_step():
        m = ts.step(shard_batch(None, next(data), device=dev))
        losses.append(float(m["loss"]))
        step = len(losses)
        if step % 5 == 0 or step == 1:
            dt = (time.time() - t0) / step
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"color {ts.color} {dt*1e3:.0f} ms/step")
        if args.fail_at and step == args.fail_at:
            print(f"!! injecting failure at step {step}; promoting backup")
            ts.restore_from_backup()

    while len(losses) < args.steps:
        if args.profile and len(losses) == 1:   # steps 2 .. N + 1, traced
            profiled(one_step, min(args.profile, args.steps - 1), dev,
                     unit="steps")
        else:
            one_step()

    print(f"first loss {losses[0]:.4f} -> last {losses[-1]:.4f} "
          f"({'improved' if losses[-1] < losses[0] else 'NO IMPROVEMENT'})")
    if mgr and mgr.latest():
        print(f"checkpoints: {len(mgr.saved)}, latest color {mgr.latest()[0]}")
    return losses


if __name__ == "__main__":
    main()
