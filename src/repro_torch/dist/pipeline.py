"""Pipeline parallelism: GPipe-style microbatch scheduling over a mesh dim
(the counterpart of ``repro.dist.pipeline``).

``pipeline_apply`` runs a stage function over stage-stacked parameters
(leading dim = number of stages) with the stages laid out along one mesh
dim.  Each schedule step every busy stage computes one microbatch and
ships its activation to the next stage with one point-to-point send: the
ML-stack analogue of the DSM channel, where ownership of the activation
moves, the bytes cross the wire exactly once, and no coherence traffic
follows.

Schedule shape (S stages, M microbatches): ``M + S - 1`` steps; the
pipeline "bubble" is the ``S * (S - 1)`` idle stage-steps at fill/drain,
i.e. a fraction ``(S - 1) / (M + S - 1)`` of every stage's time.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.torchstate import tree_leaves, tree_map
from .sharding import mesh_coord, mesh_shape


def schedule_steps(n_stages: int, n_microbatches: int) -> int:
    """Total schedule steps for a GPipe fill-steady-drain schedule."""
    return n_microbatches + n_stages - 1


def bubble_stage_steps(n_stages: int, n_microbatches: int) -> int:
    """Idle (stage, step) slots: S * (M + S - 1) total minus S * M useful."""
    return n_stages * schedule_steps(n_stages, n_microbatches) \
        - n_stages * n_microbatches


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """Fraction of stage-time lost to fill/drain: (S - 1) / (M + S - 1)."""
    return bubble_stage_steps(n_stages, n_microbatches) / (
        n_stages * schedule_steps(n_stages, n_microbatches))


def _pick_axis(mesh, n_stages: int, axis_name: str | None) -> str:
    if axis_name is not None:
        return axis_name
    shape = mesh_shape(mesh)
    if shape.get("pod") == n_stages:
        return "pod"
    for a, n in shape.items():
        if n == n_stages:
            return a
    raise ValueError(
        f"no mesh axis of size {n_stages} for the stage dim: {shape}")


def pipeline_apply(fn, mesh, stage_params, x, n_microbatches: int = 1,
                   axis_name: str | None = None):
    """Apply ``fn(stage_param, x) -> y`` sequentially over stacked stages.

    * ``stage_params``: tree whose leaves carry a leading stage dim S;
      stage ``i`` runs on rank ``i`` of the pipeline dim.
    * ``x``: global batch (the same on every rank), split into
      ``n_microbatches`` along dim 0.
    * ``fn`` must preserve the activation shape and dtype (its output
      feeds the next stage's input).

    Returns the final-stage output for the whole batch on every rank of
    the dim.  A forward only: the sends carry no gradient."""
    leaves = tree_leaves(stage_params)
    if not leaves:
        raise ValueError("stage_params has no leaves")
    S = leaves[0].shape[0]
    axis = _pick_axis(mesh, S, axis_name)
    if mesh_shape(mesh)[axis] != S:
        raise ValueError(
            f"stage dim {S} != mesh axis {axis!r}={mesh_shape(mesh)[axis]}")
    B = x.shape[0]
    M = int(n_microbatches)
    if M < 1 or B % M:
        raise ValueError(f"batch {B} not divisible into {M} microbatches")
    xm = x.reshape(M, B // M, *x.shape[1:])
    stage = mesh_coord(mesh, axis)
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)      # global rank of a stage
    p_stage = tree_map(lambda leaf: leaf[stage], stage_params)

    outs = torch.zeros_like(xm)
    for t in range(schedule_steps(S, M)):
        mb = t - stage                               # this stage's microbatch
        if not 0 <= mb < M:
            continue
        if stage == 0:
            inp = xm[mb]
        else:                      # shipped by the previous stage at t - 1
            inp = torch.empty_like(xm[0])
            _p2p(dist.irecv, inp, ranks[stage - 1], group)
        y = fn(p_stage, inp)
        if stage < S - 1:
            _p2p(dist.isend, y.contiguous(), ranks[stage + 1], group)
        else:
            outs[mb] = y
    if S > 1:          # only the last stage holds the results: share them
        dist.broadcast(outs, src=ranks[S - 1], group=group)
    return outs.reshape(B, *outs.shape[2:])


def _p2p(op, tensor, peer: int, group) -> None:
    for work in dist.batch_isend_irecv([dist.P2POp(op, tensor, peer,
                                                   group)]):
        work.wait()
