"""Collectives over a mesh dim, with the gradients of the port's SPMD model.

Every rank runs the same program on replicated tensors, and only the
explicit sharded regions (``moe_shardmap``, ``attn_decode_sharded``,
``pipeline_apply``; the reference's ``shard_map`` bodies) split work
between ranks.  The loss is therefore the same value on every rank, and
the gradient each rank must end with is that one loss's, replicated.  So a
region is entered through ``enter`` (each rank takes its part of a
replicated tensor; the backward adds every rank's gradient of its part
into the whole) and left through ``exit_sum``, ``exit_mean`` or
``exit_gather`` (the replicated result; the backward keeps the rank's own
part of the replicated gradient, with no communication).  Inside a region,
``all_to_all`` moves rows between ranks, and its backward moves their
gradients back.  Off grad mode each is its plain collective.

Every call runs its collective even on a group of one rank, so a one-card
mesh drives the same NCCL path as a larger one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .sharding import mesh_shape


def groups(mesh, axes) -> list:
    """The process groups of the mesh dims ``axes``, in mesh order."""
    names = list(mesh.mesh_dim_names)
    return [mesh.get_group(a) for a in sorted(axes, key=names.index)]


def rank_in(mesh, axes) -> tuple[int, int]:
    """(this rank's row-major index over the mesh dims ``axes``, their
    size): the part of a dim split over ``axes`` that this rank holds."""
    names = list(mesh.mesh_dim_names)
    shape, coord = mesh_shape(mesh), mesh.get_coordinate()
    idx, size = 0, 1
    for a in sorted(axes, key=names.index):
        idx, size = idx * shape[a] + coord[names.index(a)], size * shape[a]
    return idx, size


def _needs_grad(t) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def all_reduce(t, groups_, op=dist.ReduceOp.SUM):
    """``t`` reduced with ``op`` over every rank of ``groups_`` (a new
    tensor; no gradient)."""
    t = t.clone()
    for g in groups_:
        dist.all_reduce(t, op=op, group=g)
    return t


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, index, groups_):
        ctx.index, ctx.groups, ctx.shape = index, groups_, t.shape
        return t[index]

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[ctx.index] = g
        return all_reduce(full, ctx.groups), None, None


def enter(t, index, groups_):
    """``t[index]``: this rank's part of the replicated ``t`` in a region
    split over ``groups_``."""
    if not _needs_grad(t):
        return t[index]
    return _Enter.apply(t, index, groups_)


class _ExitSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups_):
        return all_reduce(t, groups_)

    @staticmethod
    def backward(ctx, g):
        return g, None


def exit_sum(t, groups_):
    """The sum of every rank's partial ``t`` over ``groups_``."""
    if not _needs_grad(t):
        return all_reduce(t, groups_)
    return _ExitSum.apply(t, groups_)


class _ExitMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups_):
        ctx.n = 1
        for g in groups_:
            ctx.n *= dist.get_world_size(g)
        return all_reduce(t, groups_) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def exit_mean(t, groups_):
    """The mean of every rank's ``t`` over ``groups_`` (``pmean``)."""
    return _ExitMean.apply(t, groups_)


def _gather(t, dim, group):
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _gather_all(t, dim, groups_):
    for g in reversed(groups_):               # the innermost dim first
        t = _gather(t, dim, g)
    return t


class _ExitGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, groups_):
        ctx.dim, ctx.groups = dim, groups_
        return _gather_all(t, dim, groups_)

    @staticmethod
    def backward(ctx, g):
        for grp in ctx.groups:                # outermost first
            n, r = dist.get_world_size(grp), dist.get_rank(grp)
            g = g.chunk(n, dim=ctx.dim)[r]
        return g.contiguous(), None, None


def exit_gather(t, dim: int, groups_):
    """Every rank's part of a tensor split along ``dim`` over ``groups_``
    (mesh order, row-major), put back together."""
    if not _needs_grad(t):
        return _gather_all(t, dim, groups_)
    return _ExitGather.apply(t, dim, groups_)


def _a2a(t, group):
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _a2a(t, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def all_to_all(t, group):
    """Block ``i`` of dim 0 goes to rank ``i`` of ``group``; block ``j`` of
    the result came from rank ``j`` (``lax.all_to_all(t, axis, 0, 0)``)."""
    if not _needs_grad(t):
        return _a2a(t, group)
    return _AllToAll.apply(t, group)
