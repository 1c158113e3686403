"""Mixture-of-Experts block on one device: top-k token-choice routing with
capacity (the counterpart of ``repro.models.moe`` with
``axis_name=None``).

Dispatch is sort-free, as in the reference: each expert takes its top-C
tokens by router score (capacity drop like GShard).  The reference walks
the experts one by one; here all E are gathered at once into the
``(E, C, D)`` capacity buffers and the expert MLP runs as three grouped
matmuls over them (gate, up, down): ``moe_gmm`` (K3) on the card, its plain
version on the CPU or with ``attn_impl="plain"``.  Each expert's kept
tokens fill the first slots of its buffer (``topk`` sorts, and a dropped or
empty slot scores -inf), so the matmuls are told each expert's kept count
(``rows``) and skip the weights of experts that received no token; the
slots past it are zeros, which the reference's ``keep`` mask makes of them
anyway.  The output is summed over experts in float32 and cast once, so
the bf16 result does not depend on the order of ``index_add_``'s atomics.

Expert parallelism over the ``model`` dim of a mesh (``moe_shardmap``):
the default dispatch runs ``moe_block`` on each rank's local experts for
its data shard of the tokens and sums the partial outputs over ``model``
(the reference's gather + psum); with ``cfg.moe_a2a`` each rank keeps its
sequence shard and ships its tokens' top-k copies to the experts' owners
with ``all_to_all`` (``moe_a2a_block``), which sorts the rows it receives
by local expert into one packed buffer and runs the expert MLP as ragged
grouped matmuls over it (``gmm`` with ``starts``), each row once.  Both
dispatches go through ``gmm`` (K3 on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import telemetry
from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import data_axes, mesh_coord, mesh_shape
from repro_torch.kernels import ops, ref
from .config import ModelConfig
from . import layers as L


def moe_params(cfg: ModelConfig, gen: torch.Generator, dtype, device):
    """router (D, E) float32, as the reference keeps it in a bf16 model;
    experts w_gate/w_up (E, D, F) and w_down (E, F, D) in ``dtype``."""
    d, f, E = cfg.d_model, cfg.e_ff, cfg.n_experts
    s = d ** -0.5
    return {
        "router": L.normal(gen, (d, E), torch.float32, device) * s,
        "w_gate": L.normal(gen, (E, d, f), dtype, device) * s,
        "w_up": L.normal(gen, (E, d, f), dtype, device) * s,
        "w_down": L.normal(gen, (E, f, d), dtype, device) * f ** -0.5,
    }


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = max(1, int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    c = -(-c // 4) * 4                                  # multiple of 4
    return min(n_tokens, c)


def _top_k(cfg: ModelConfig, p, xt):
    """Router of the tokens xt (N, D) -> (aux_loss, top_p (N, K)
    renormalised, top_ids (N, K))."""
    N = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = torch.topk(probs, K, dim=-1)                # (N, K)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=0)                                       # (E,)
    ce = torch.zeros(E, dtype=torch.float32, device=xt.device).index_add_(
        0, top_ids.reshape(-1),
        torch.full((N * K,), 1.0 / (N * K), device=xt.device))
    aux = E * torch.sum(me * ce)
    return aux, top_p, top_ids


def _route(cfg: ModelConfig, p, xt):
    """Route the tokens xt (N, D) -> (aux_loss, g, idx, keep): each
    expert's top-C router scores g (E, C), -inf where no token fills the
    slot, their token ids idx (E, C) and keep = g > -inf, which holds on a
    prefix of each row."""
    N = xt.shape[0]
    E = cfg.n_experts
    aux, top_p, top_ids = _top_k(cfg, p, xt)

    # per-token score for each expert: router prob if chosen, else -inf
    assigned = torch.full((N, E), float("-inf"), device=xt.device)
    assigned.scatter_(1, top_ids, top_p)

    # every expert's top-C tokens at once: (E, C) gates and token ids
    C = _capacity(cfg, N)
    g, idx = torch.topk(assigned.T, C, dim=1)
    return aux, g, idx, g > float("-inf")


def moe_block(cfg: ModelConfig, p, x, axis_name: str | None = None,
              axis_size: int = 1, mesh=None):
    """x: (B, T, D).  Returns (y (B, T, D), aux_loss).

    With ``axis_name`` (a dim of ``mesh``, of ``axis_size`` ranks) ``p``
    holds this rank's slice of the experts, ``E / axis_size`` of them from
    ``e0 = rank * E_loc``: the tokens are routed over all E, the local
    experts run, and the partial outputs are summed over the dim.

    While the profiler runs, the block is the span ``repro_torch/moe``
    and, without ``axis_name``, counts its routed (token, expert) pairs,
    N x top_k, in ``moe/routed_pairs`` and the pairs its experts kept
    under their capacity in ``moe/kept_pairs`` (on the device)."""
    with telemetry.span("repro_torch/moe"):
        B, T, D = x.shape
        N = B * T
        E_loc = cfg.n_experts // axis_size
        xt = x.reshape(N, D)
        aux, g, idx, keep = _route(cfg, p, xt)
        if axis_name is not None:
            e0 = mesh_coord(mesh, axis_name) * E_loc
            g, idx, keep = (t[e0:e0 + E_loc] for t in (g, idx, keep))
        C = idx.shape[1]
        gate = torch.where(keep, g, 0.0).to(x.dtype)
        rows = keep.sum(1, dtype=torch.int32)      # kept slots, on the device
        if axis_name is None:
            telemetry.count("moe/routed_pairs", N * cfg.top_k)
            telemetry.count("moe/kept_pairs", rows)
        xe = xt[idx]                                             # (E, C, D)
        gmm = ops.moe_gmm if L.use_kernels(cfg, x) else ref.moe_gmm
        h = F.silu(gmm(xe, p["w_gate"], rows)) * gmm(xe, p["w_up"], rows)
        out = gmm(h, p["w_down"], rows) * gate[..., None]        # (E, C, D)
        out = torch.where(keep[..., None], out, 0.0)
        y = torch.zeros((N, D), dtype=torch.float32, device=x.device)
        y.index_add_(0, idx.reshape(-1), out.reshape(E_loc * C, D).float())
        if axis_name is not None:
            y = coll.exit_sum(y, coll.groups(mesh, (axis_name,)))
        return y.to(x.dtype).reshape(B, T, D), aux


_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def moe_shardmap(cfg: ModelConfig, mesh, p, x):
    """The MoE over a mesh: tokens split over the data dims (``pod``,
    ``data``), experts over ``model``.  ``p`` and ``x`` (B, T, D) are the
    replicated globals; returns the global (y, aux) on every rank, aux
    averaged over the data and model ranks (the reference's ``pmean``).

    The default dispatch gives each rank its data shard of the tokens and
    its ``model`` slice of the experts (``moe_block`` with ``axis_name``).
    With ``cfg.moe_a2a`` (when ``model`` divides T) each rank also keeps
    only its sequence shard and routes it with ``moe_a2a_block``."""
    dp = data_axes(mesh)
    n_model = mesh_shape(mesh)["model"]
    E_loc = cfg.n_experts // n_model
    region = coll.groups(mesh, dp + ("model",))
    b, n_dp = coll.rank_in(mesh, dp)
    B, T, _ = x.shape
    if B % n_dp:
        raise ValueError(f"batch {B} does not split over the data dims "
                         f"{dp} of {n_dp} ranks")
    e0 = mesh_coord(mesh, "model") * E_loc
    p_loc = {k: coll.enter(v, slice(e0, e0 + E_loc) if k in _EXPERT_LEAVES
                           else slice(None), region)
             for k, v in p.items()}
    rows = slice(b * (B // n_dp), (b + 1) * (B // n_dp))

    if cfg.moe_a2a and T % n_model == 0:
        t = mesh_coord(mesh, "model")
        T_loc = T // n_model
        x_loc = coll.enter(x, (rows, slice(t * T_loc, (t + 1) * T_loc)),
                           region)
        y, aux = moe_a2a_block(cfg, p_loc, x_loc, n_model, mesh=mesh)
        y = coll.exit_gather(y, 1, coll.groups(mesh, ("model",)))
    else:
        x_loc = coll.enter(x, rows, region)
        y, aux = moe_block(cfg, p_loc, x_loc, axis_name="model",
                           axis_size=n_model, mesh=mesh)
    return (coll.exit_gather(y, 0, coll.groups(mesh, dp)),
            coll.exit_mean(aux, region))


def moe_a2a_block(cfg: ModelConfig, p, x, n_model: int,
                  axis_name: str = "model", mesh=None):
    """Expert-parallel MoE with all-to-all dispatch, on one rank of the
    ``axis_name`` dim of ``mesh``: x (B_loc, T_loc, D) is this rank's token
    shard and ``p`` holds its slice of the experts (E_loc, D, F).

    Each destination rank gets a send buffer of capacity
    ``C = max(4, ceil4(N k cf / n_model))`` (at most N k) holding the
    top-C (token, expert) pairs routed to it by gate; three
    ``all_to_all`` calls ship tokens, token ids and local expert ids.  The
    received rows are sorted by local expert into one packed buffer, and
    the gate, up and down products run over it as ragged grouped matmuls
    (``gmm`` with ``rows`` and ``starts``: K3 on the card, its plain
    version on the CPU), each row multiplied once by its expert, where the
    reference multiplies every row by every local expert and masks.  One
    ``all_to_all`` ships the results back, and each is added to its token
    scaled by its gate.  Every shape is static (no row is picked by
    value), so the dispatch traces on fake tensors."""
    B, T, D = x.shape
    N = B * T
    K = cfg.top_k
    E_loc = cfg.n_experts // n_model
    xt = x.reshape(N, D)
    aux, top_p, top_ids = _top_k(cfg, p, xt)

    dest = top_ids // E_loc                                      # (N, K)
    cap = max(4, -(-int(N * K * cfg.capacity_factor / n_model) // 4) * 4)
    cap = min(cap, N * K)
    flat_tok = torch.arange(N, device=x.device).repeat_interleave(K)
    flat_exp = top_ids.reshape(-1)
    flat_gate = top_p.reshape(-1)
    flat_dest = dest.reshape(-1)

    # per-destination send buffers: the top-cap (token, expert) pairs
    score = torch.where(
        flat_dest[None, :] == torch.arange(n_model, device=x.device)[:, None],
        flat_gate[None, :], float("-inf"))                     # (n_model, NK)
    g, idx = torch.topk(score, cap, dim=1)
    keep = g > float("-inf")
    send_x = torch.where(keep[..., None], xt[flat_tok[idx]], 0.0)
    send_tok = torch.where(keep, flat_tok[idx], -1).to(torch.int32)
    send_eloc = (flat_exp[idx] % E_loc).to(torch.int32)
    send_gate = torch.where(keep, g, 0.0)

    group = coll.groups(mesh, (axis_name,))[0]
    rx = coll.all_to_all(send_x, group).reshape(n_model * cap, D)
    r_tok = coll.all_to_all(send_tok, group).reshape(-1)
    r_eloc = coll.all_to_all(send_eloc, group).reshape(-1)
    r_valid = r_tok >= 0

    # the local experts on the received rows, each row once: the rows
    # sorted by local expert (stably, the rows of no expert last), each
    # expert's count and first row, and one ragged K3 call a product over
    # the packed buffer; static shapes, so a trace on fake tensors sizes it
    key = torch.where(r_valid, r_eloc.long(), E_loc)
    perm = torch.argsort(key, stable=True)
    counts = torch.zeros(E_loc + 1, dtype=torch.int32, device=x.device)
    counts.scatter_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    rows = counts[:E_loc]
    starts = torch.cumsum(rows, 0, dtype=torch.int32) - rows
    xs = rx[perm]
    gmm = ops.moe_gmm if L.use_kernels(cfg, x) else ref.moe_gmm
    h = F.silu(gmm(xs, p["w_gate"], rows, starts)) \
        * gmm(xs, p["w_up"], rows, starts)
    o = gmm(h, p["w_down"], rows, starts)
    out = torch.zeros_like(o).index_copy(0, perm, o)

    back = coll.all_to_all(out.reshape(n_model, cap, D), group)
    tok = torch.clamp_min(send_tok, 0).reshape(-1).long()
    gate = torch.where(send_tok >= 0, send_gate, 0.0).reshape(-1)
    y = torch.zeros((N, D), dtype=torch.float32, device=x.device)
    y = y.index_add(0, tok, back.reshape(-1, D).float() * gate[:, None])
    return y.to(x.dtype).reshape(B, T, D), aux
