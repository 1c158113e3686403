"""End-to-end training driver, on the card (the counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        [--full] [--layers N] [--device cuda] [--steps 30] [--batch 8] \\
        [--seq 256] [--microbatches 1] [--optimizer adamw|adafactor] \\
        [--lr 3e-3] [--chunked-ce N] [--ckpt-dir DIR] [--ckpt-every 10] \\
        [--no-backup]   (no epoch backup: a full copy of the train state) \\
        [--fail-at N]   (inject a failure: restore from the epoch backup) \\
        [--profile N]   (trace N steps after the first with torch.profiler)

Runs the real loop: synthetic data -> ownership-wrapped train state ->
step (in-place update, color bump per epoch) -> epoch-batched
checkpointing -> optional failure injection and recovery.  Without
``--full`` it trains the reduced ``smoke()`` config; ``--layers N`` cuts
the depth at the same widths; ``--chunked-ce N`` computes the head and the
loss in N sequence chunks, each recomputed in the backward (a 256000-word
vocabulary's float32 logits at B=8, T=1024 are 8.4 GB).  Weights are
random, from a seeded ``torch.Generator``.  ``--device`` defaults to ``cuda`` and raises without
a card; on the card every family trains through the kernels and their
backward kernels (K2 attention, K3 experts, K4 RWKV6, K5 RG-LRU).  At full
size on one 80 GB card, recurrentgemma-9b and the MoE configs (cut with
``--layers``) need ``--optimizer adafactor``: AdamW's float32 moments do
not fit beside their parameters and gradients, and every full-size model
but qwen3-0.6b needs ``--no-backup``: the epoch backup is a copy of the
parameters and the optimizer state, refreshed each step.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

# a full-size step frees and allocates leaf-sized float32 temporaries (the
# optimizer's) beside the parameters and gradients: without expandable
# segments the cache fragments and the MoE's 9 GB temporaries do not fit
ALLOC_CONF = "expandable_segments:True"


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
    ap.add_argument("--no-backup", dest="backup", action="store_false",
                    help="keep no epoch backup of the train state")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "adafactor"))
    ap.add_argument("--chunked-ce", type=int, default=0, metavar="N",
                    help="the head and the loss in N sequence chunks")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace N steps after the first with torch.profiler")
    args = ap.parse_args(argv)
    if args.fail_at and not args.backup:
        ap.error("--fail-at restores from the epoch backup: drop --no-backup")

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOC_CONF)
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
    if args.chunked_ce:
        cfg = dataclasses.replace(cfg, chunked_ce=args.chunked_ce)
    dev = resolve_device(args.device)
    gen = torch.Generator(dev if dev.type == "cuda" else "cpu")
    params = init_params(cfg, gen.manual_seed(0), device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M "
          f"batch={args.batch}x{args.seq} optimizer={args.optimizer}")

    opt = OptConfig(name=args.optimizer, lr=args.lr, warmup=5,
                    decay_steps=args.steps * 2)
    ts = TrainState(cfg, opt, params, microbatches=args.microbatches)
    if args.backup:
        ts.replicate()                            # §4.2.3 backup slot
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
    if dev.type == "cuda":
        print(f"peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    if mgr and mgr.latest():
        print(f"checkpoints: {len(mgr.saved)}, latest color {mgr.latest()[0]}")
    return losses


if __name__ == "__main__":
    main()
