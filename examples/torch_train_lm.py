"""End-to-end driver through the PyTorch port: train a ~100M-param dense
LM for a few hundred steps with ownership-epoch checkpointing.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]
        [--d-model 512] [--device cpu]

The model runs on ``--device`` (default ``cuda``); checkpoints
go to ``--ckpt-dir`` (default ``build/torch_train_lm`` in the checkout).
For the published configs at full size use ``repro_torch.launch.train
--full`` with an arch id.
"""

import argparse
import dataclasses
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", type=Path,
                    default=ROOT / "build" / "torch_train_lm")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.torchstate import tree_leaves
    from repro_torch.models import init_params
    from repro_torch.models.transformer import resolve_device
    from repro_torch.train import (OptConfig, TrainState, shard_batch,
                                   synthetic_batches)

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(
        configs.get("qwen3-0.6b"), n_layers=args.layers,
        d_model=args.d_model, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=args.d_model * 3, vocab=8192, attn_chunk=128,
        max_target_len=args.seq)
    gen = torch.Generator(dev if dev.type == "cuda" else "cpu")
    params = init_params(cfg, gen.manual_seed(0), device=dev)
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"model: {args.layers}L d={args.d_model} -> {n/1e6:.1f}M params "
          f"on {dev}")

    ts = TrainState(cfg, OptConfig(lr=1e-3, warmup=20,
                                   decay_steps=args.steps), params)
    ts.replicate()
    mgr = CheckpointManager(args.ckpt_dir, ts.state, every_n_epochs=50)
    data = synthetic_batches(cfg.vocab, args.batch, args.seq)

    t0 = time.time()
    losses = []
    for step in range(1, args.steps + 1):
        m = ts.step(shard_batch(None, next(data), device=dev))
        losses.append(float(m["loss"]))
        if step % 20 == 0:
            rate = args.batch * args.seq * step / (time.time() - t0)
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"{rate/1e3:.1f}k tok/s  color {ts.color}")
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"checkpoints at colors {[c for c, _ in mgr.saved]}")
    if losses[-1] >= losses[0]:
        raise SystemExit("the loss did not fall")


if __name__ == "__main__":
    main()
