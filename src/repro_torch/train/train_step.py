"""Train step factory: loss, gradients and the optimizer update, with
microbatch gradient accumulation and the ownership-epoch hook (the
counterpart of ``repro.train.train_step``).

Gradients come from ``torch.autograd.grad`` through ``models.loss_fn``: on
the card, attention runs in K2 and its backward kernel.  There is no
``jit`` and no donation: ``apply_updates`` writes the new parameters and
optimizer state into the old tensors, which is the port's donation.
``TrainState`` puts (params, opt_state) under ``OwnedState``, so each step
is one mutable-borrow epoch whose color bump at the drop is what replicas
and checkpointers key their refresh on (DESIGN §2.2).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import telemetry
from repro_torch.core.torchstate import (OwnedState, ReplicaSlot,
                                         tree_leaves, tree_map)
from repro_torch.models import loss_fn
from repro_torch.models.config import ModelConfig
from .optimizer import OptConfig, apply_updates, init_opt_state


def _unflatten(tree, leaves):
    """``tree`` with its leaves replaced, in ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _replicated(batch):
    """The batch with each ``DTensor`` leaf (``shard_batch`` on a mesh)
    gathered whole: the model's tensors are replicated on every rank."""
    from torch.distributed.tensor import DTensor
    return {k: v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt: OptConfig, mesh=None,
                    microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) with metrics {loss, grad_norm, lr}; params and opt_state are
    updated in place and returned.  ``mesh`` is passed on to ``loss_fn``;
    on it the parameters and optimizer state are replicated, so every rank
    ends the step with the same ones.

    With microbatches > 1 the batch is split along axis 0 and the
    gradients accumulate in float32 over the microbatches, one after the
    other, then are divided by their number, as in the reference."""

    def value_and_grad(params, batch):
        # leaves that require grad, sharing storage with the parameters:
        # the caller's tensors keep requires_grad as they were
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            with telemetry.span("repro_torch/forward"):
                loss = loss_fn(cfg, _unflatten(params, leaves), batch,
                               mesh=mesh)
            with telemetry.span("repro_torch/backward"):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), grads

    def grads_of(params, batch):
        if microbatches <= 1:
            loss, grads = value_and_grad(params, batch)
            return loss, _unflatten(params, grads)
        for k, x in batch.items():
            if x.shape[0] % microbatches:
                raise ValueError(f"batch[{k!r}] axis 0 of {x.shape[0]} does "
                                 f"not split into {microbatches}")
        n = next(iter(batch.values())).shape[0] // microbatches
        loss_acc = torch.zeros((), dtype=torch.float32)
        g_acc = None
        for i in range(microbatches):
            mb = {k: x[i * n:(i + 1) * n] for k, x in batch.items()}
            loss, grads = value_and_grad(params, mb)
            loss_acc = loss_acc.to(loss.device) + loss.float()
            if g_acc is None:
                g_acc = [g.float() for g in grads]
            else:
                for a, g in zip(g_acc, grads):
                    a += g.float()
        inv = 1.0 / microbatches
        return loss_acc * inv, _unflatten(params, [g * inv for g in g_acc])

    def train_step(params, opt_state, batch):
        loss, grads = grads_of(params, _replicated(batch))
        with telemetry.span("repro_torch/optimizer"):
            params, opt_state, metrics = apply_updates(opt, params, grads,
                                                       opt_state)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


class TrainState:
    """Host-side ownership wrapper around (params, opt_state).

    Each ``step`` is one write epoch: mutable borrow -> in-place update ->
    color bump on drop.  ``replicate()`` attaches a §4.2.3 backup slot
    whose write-back is batched per epoch (a copy: the live tensors are
    updated in place by the next step)."""

    def __init__(self, cfg: ModelConfig, opt: OptConfig, params,
                 mesh=None, microbatches: int = 1):
        self.cfg, self.opt = cfg, opt
        opt_state = init_opt_state(opt, params)
        self.state = OwnedState("train_state", (params, opt_state))
        self._step = make_train_step(cfg, opt, mesh=mesh,
                                     microbatches=microbatches)
        self.replicas: list[ReplicaSlot] = []
        self.metrics: dict[str, Any] = {}

    def replicate(self) -> ReplicaSlot:
        slot = ReplicaSlot(self.state)
        self.replicas.append(slot)
        return slot

    @property
    def color(self) -> int:
        return self.state.color

    def step(self, batch):
        with telemetry.span(telemetry.STEP), self.state.borrow_mut() as ref:
            params, opt_state = ref.deref_mut()
            params, opt_state, metrics = self._step(params, opt_state, batch)
            ref.set((params, opt_state))
        self.metrics = metrics
        return metrics

    def params(self):
        return self.state.read()[0]

    def restore_from_backup(self):
        """Failure path: promote the newest backup (checkpoint/restart)."""
        if not self.replicas:
            raise RuntimeError("no replica slot attached")
        self.replicas[-1].promote()
        return self.state.color
