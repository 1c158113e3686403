"""Training in PyTorch: optimizers, the train step with microbatch
accumulation and ownership epochs, and synthetic data (the counterpart of
``repro.train``)."""

from .optimizer import OptConfig, init_opt_state, apply_updates
from .train_step import make_train_step, TrainState
from .data import synthetic_batches, shard_batch

__all__ = ["OptConfig", "TrainState", "apply_updates", "init_opt_state",
           "make_train_step", "shard_batch", "synthetic_batches"]
