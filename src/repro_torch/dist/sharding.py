"""Sharding rules: the partition map between logical tensors and the mesh
(the counterpart of ``repro.dist.sharding``).

The DSM core gives every object one logical address and a per-server
partition of the physical backing (GlobalHeap); this module is the same
contract for the model stack.  Every spec produced here goes through
``_fit``, which drops any mesh axis that does not evenly divide the
corresponding tensor dimension, so one rule table serves every
architecture and every mesh shape, degrading to replication instead of
failing to partition.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``"pod"``, ``"data"``, ``"model"``; see ``launch/mesh.py``), or any
object whose ``.shape`` maps axis names to sizes (a stand-in for the spec
functions, which never touch a device).  A spec is this module's
``PartitionSpec``, a tuple whose entries are ``None``, an axis name or a
tuple of axis names, as in the reference; ``to_placements`` turns one into
DTensor placements.

Layout contract (see ``models/layers.py``):
  * attention projections:  wq (D, H, hd)   wk/wv (D, Hkv, hd)   wo (H, hd, D)
  * MLP:                    w_gate/w_up (D, F)   w_down (F, D)
  * MoE experts:            (E, D, F) / (E, F, D), expert dim over ``model``
  * stacked layer trees carry a leading layer dim: rules match the
    *trailing* dims, so stacked and unrolled trees share one table.

Rule flags (process-wide, like the mesh registry):
  * ``dp_only``       pure ZeRO-3: every leaf FSDP-sharded along its first
                      dividing dim over *all* mesh axes; batch over all axes.
  * ``serve_weights`` TP-only weights (no FSDP data axes).
  * ``ulysses``       inputs arrive sequence-sharded over ``model``.

Where the reference leaves a layout to XLA's partitioner
(``shard_act``, ``ulysses_heads``), layout never changes a value: the
port's model tensors stay plain and replicated on every rank, and these
two redistribute only a ``DTensor`` (ROADMAP Queue 3, divergences by
design).
"""

from __future__ import annotations

import re
import weakref

from repro_torch.core.torchstate import tree_leaves, tree_map

# ---------------------------------------------------------------------------
#  specs and placements
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), an axis name, or a
    tuple of axis names (the dim split over each, in mesh order).  As in
    JAX, a one-name tuple is stored as the name and an empty one as None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


_SHAPES: dict = {}          # id(mesh) -> (weakref to it, its shape dict)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of an object whose
    ``.shape`` is such a mapping."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        names = getattr(mesh, "mesh_dim_names", None)
        return dict(zip(names, mesh.shape) if names else mesh.shape)
    # some torch releases rebuild a DeviceMesh's rank tensor to read its
    # shape, a host cost on every layer of every step: read it once a mesh
    names = mesh.mesh_dim_names
    hit = _SHAPES.get(id(mesh))
    if hit is None or hit[0]() is not mesh:
        hit = (weakref.ref(mesh), dict(zip(names, mesh.shape)))
        _SHAPES[id(mesh)] = hit
    return dict(hit[1])


def mesh_coord(mesh, axis: str) -> int:
    """This rank's index along the mesh dim ``axis``."""
    return mesh.get_coordinate()[list(mesh.mesh_dim_names).index(axis)]


def to_placements(mesh, spec) -> list:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names it, else
    ``Replicate()``.  A tuple entry must list its axes in mesh order (the
    order JAX splits the dim in; DTensor splits by mesh dim order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {axes} is not in the mesh order "
                             f"{tuple(names)}")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"mesh dim {names[i]!r} named twice in "
                                 f"{spec}")
            out[i] = Shard(d)
    return out


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def place(tree, specs, mesh):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` (moved to its
    device type), laid out by the spec beside it in ``specs`` (a tree of
    the same structure, e.g. ``param_specs(mesh, tree)``), cut from this
    rank's copy of the whole tensor with no communication: every rank must
    hold the same tree."""
    from torch.distributed.tensor import distribute_tensor

    leaves = iter(tree_leaves(specs, is_leaf=is_spec))
    return tree_map(lambda t: distribute_tensor(
        t.to(mesh.device_type), mesh, to_placements(mesh, next(leaves)),
        src_data_rank=None), tree)


# ---------------------------------------------------------------------------
#  mesh + rule-flag registry
# ---------------------------------------------------------------------------
_MESH = None
_FLAGS = {"ulysses": False, "dp_only": False, "serve_weights": False}


def set_mesh(mesh):
    """Install (or clear, with ``None``) the process-wide mesh."""
    global _MESH
    _MESH = mesh
    return mesh


def current_mesh():
    return _MESH


def set_rule_flags(**flags):
    """Update rule flags; unknown keys are rejected."""
    for k, v in flags.items():
        if k not in _FLAGS:
            raise ValueError(f"unknown rule flag {k!r}")
        _FLAGS[k] = bool(v)
    return dict(_FLAGS)


def rule_flags() -> dict:
    return dict(_FLAGS)


# ---------------------------------------------------------------------------
#  divisor fitting
# ---------------------------------------------------------------------------
def _axis_size(mesh, axes) -> int | None:
    """Product of the named axes' sizes; None if any axis is absent."""
    shape = mesh_shape(mesh)
    n = 1
    for a in axes if isinstance(axes, tuple) else (axes,):
        sz = shape.get(a)
        if sz is None:
            return None
        n *= sz
    return n


def _fit(mesh, spec, shape) -> PartitionSpec:
    """Fit ``spec`` to ``shape``: drop every axis that does not divide.

    Tuple entries keep their longest dividing *prefix*; plain entries are
    kept or dropped whole.  A spec longer than the shape is truncated;
    shorter is padded with None."""
    entries = tuple(spec)[:len(shape)]
    entries = entries + (None,) * (len(shape) - len(entries))
    out = []
    for dim, axes in zip(shape, entries):
        if axes is None:
            out.append(None)
        elif isinstance(axes, tuple):
            kept = axes
            while kept:
                n = _axis_size(mesh, kept)
                if n is not None and dim % n == 0:
                    break
                kept = kept[:-1]
            out.append(kept if kept else None)
        else:
            n = _axis_size(mesh, axes)
            out.append(axes if n is not None and dim % n == 0 else None)
    return P(*out)


def data_axes(mesh) -> tuple:
    """The mesh dims that carry the batch (and FSDP): ``pod`` and
    ``data``, those present."""
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))


def _dp_axes(mesh) -> tuple:
    """Axes that carry the batch: (pod, data) normally, every axis under
    dp_only."""
    if _FLAGS["dp_only"]:
        return tuple(mesh_shape(mesh))
    return data_axes(mesh)


# ---------------------------------------------------------------------------
#  parameter rules
# ---------------------------------------------------------------------------
# (path regex, trailing-dim tokens).  First match wins; tokens are
# "dp" (FSDP axes), "model" (TP axis), or None (replicated).  Rules name
# only the trailing dims: stacking pads None on the left.
_PARAM_RULES: tuple[tuple[str, tuple], ...] = (
    # attention projections
    (r"attn/wq$",            ("dp", "model", None)),
    (r"attn/(wk|wv)$",       ("dp", "model", None)),
    (r"attn/wo$",            ("model", None, "dp")),
    # dense MLP
    (r"mlp/(w_gate|w_up)$",  ("dp", "model")),
    (r"mlp/w_down$",         ("model", "dp")),
    # MoE: expert dim over model (expert parallelism), D FSDP-sharded
    (r"moe/(w_gate|w_up)$",  ("model", "dp", None)),
    (r"moe/w_down$",         ("model", None, "dp")),
    (r"moe/router$",         (None, "model")),
    # RG-LRU recurrent block
    (r"rec/(w_in|w_gate)$",  ("dp", "model")),
    (r"rec/(wa|wx)$",        ("dp", "model")),
    (r"rec/w_out$",          ("model", "dp")),
    (r"rec/conv$",           (None, "model")),
    # RWKV time-mix / channel-mix (flat under the layer dict)
    (r"(wr|wk|wv|wg|wo|cr)$", ("dp", "model")),
    (r"ck$",                 ("dp", "model")),
    (r"cv$",                 ("model", "dp")),
    # embeddings / head
    (r"embed$",              ("model", "dp")),
    (r"lm_head$",            ("dp", "model")),
)
_COMPILED_RULES = tuple((re.compile(rx), spec) for rx, spec in _PARAM_RULES)


def _path_str(path) -> str:
    """A leaf's path, its dict keys and list indices joined with ``/`` (the
    format of ``checkpoint._flatten`` and of the reference's paths)."""
    return "/".join(str(k) for k in path)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a dict/list/tuple tree, keeping its
    structure."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _shape(leaf) -> tuple:
    """A tensor's shape; ``()`` for a Python scalar (a cache's ``length``)."""
    return tuple(getattr(leaf, "shape", ()))


def _resolve(token, mesh):
    if token == "dp":
        if _FLAGS["serve_weights"]:
            return None
        return data_axes(mesh) or None
    return token


def _zero3_spec(mesh, shape) -> PartitionSpec:
    """dp_only: FSDP-shard the dim covering the most mesh axes (longest
    dividing prefix of the full axis tuple); earliest dim wins ties."""
    axes = tuple(mesh_shape(mesh))
    best = None                                  # (coverage, dim, kept)
    for i, dim in enumerate(shape):
        kept = axes
        while kept:
            n = _axis_size(mesh, kept)
            if n is not None and dim % n == 0:
                break
            kept = kept[:-1]
        if kept:
            cov = _axis_size(mesh, kept)
            if best is None or cov > best[0]:
                best = (cov, i, kept)
    entries = [None] * len(shape)
    if best is not None:
        entries[best[1]] = best[2]
    return P(*entries)


def _param_spec(mesh, path, leaf) -> PartitionSpec:
    shape = _shape(leaf)
    if _FLAGS["dp_only"]:
        return _zero3_spec(mesh, shape)
    name = _path_str(path)
    for rx, tokens in _COMPILED_RULES:
        if rx.search(name):
            resolved = tuple(_resolve(t, mesh) for t in tokens)
            resolved = resolved[-len(shape):] if shape else ()
            full = (None,) * (len(shape) - len(resolved)) + resolved
            return _fit(mesh, P(*full), shape)
    return P(*([None] * len(shape)))


def param_specs(mesh, params):
    """PartitionSpec tree mirroring ``params`` (tensors of any device,
    ``meta`` included)."""
    return _map_with_path(lambda path, leaf: _param_spec(mesh, path, leaf),
                          params)


def opt_state_specs(mesh, opt_state, params):
    """Moments are TBox-tied to their parameters: each moment leaf inherits
    the parameter's spec, re-fitted to its own shape (Adafactor's collapsed
    dims fall back to replication along that dim)."""
    pspecs = param_specs(mesh, params)

    def tied(subtree):
        return _map_with_path(
            lambda path, leaf: _fit(mesh, _at(pspecs, path), _shape(leaf)),
            subtree)

    return {k: (tied(v) if isinstance(v, dict) else P())
            for k, v in opt_state.items()}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
#  data / activation / cache specs
# ---------------------------------------------------------------------------
def batch_specs(mesh, batch):
    """Inputs: batch dim over the dp axes; under the ulysses flag the
    sequence dim is additionally sharded over ``model``."""
    dp = _dp_axes(mesh)
    seq = "model" if (_FLAGS["ulysses"] and not _FLAGS["dp_only"]) else None

    def one(leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if nd == 0:
            return P()
        entries = (dp or None,) + (seq,) * (1 if nd > 1 else 0) \
            + (None,) * max(0, nd - 2)
        return _fit(mesh, P(*entries), shape)

    return tree_map(one, batch)


def activation_spec(mesh, shape) -> PartitionSpec:
    """(B, T, D) residual-stream layout: batch over dp, sequence over
    ``model``.  dp_only drops the sequence sharding."""
    dp = _dp_axes(mesh)
    if len(shape) == 0:
        return P()
    if _FLAGS["dp_only"]:
        entries = (dp or None,) + (None,) * (len(shape) - 1)
    else:
        entries = (dp or None,) \
            + (("model",) if len(shape) > 1 else ()) \
            + (None,) * max(0, len(shape) - 2)
    return _fit(mesh, P(*entries), shape)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_act(x, mesh=None):
    """Lay an activation out in the canonical layout.  The identity off a
    mesh and for a plain tensor, which is replicated on every rank."""
    mesh = mesh if mesh is not None else _MESH
    if mesh is None or not _is_dtensor(x):
        return x
    return x.redistribute(mesh, to_placements(
        mesh, activation_spec(mesh, x.shape)))


def ulysses_heads(x, mesh=None):
    """Ulysses sequence parallelism: lay (B, T, H, hd) out heads-over-model.
    The identity off a mesh and for a plain tensor, which is replicated on
    every rank."""
    mesh = mesh if mesh is not None else _MESH
    if mesh is None or not _is_dtensor(x) or "model" not in mesh_shape(mesh):
        return x
    dp = data_axes(mesh)
    return x.redistribute(mesh, to_placements(
        mesh, _fit(mesh, P(dp or None, None, "model", None), x.shape)))


def cache_specs(mesh, cache):
    """KV / recurrent-state caches: batch over dp; 4-D leaves (attention
    k/v (B, S, Hkv, hd), rwkv S (B, H, M, M)) shard dim 1 over ``model``
    so decode attention can keep every cache shard local."""
    dp = _dp_axes(mesh)
    # dp_only already spreads the batch over `model`; reusing it on the
    # sequence dim would duplicate the axis in one spec
    seq = None if _FLAGS["dp_only"] else "model"

    def one(leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if nd == 0:
            return P()
        if nd >= 4:
            entries = (dp or None, seq) + (None,) * (nd - 2)
        elif nd >= 2:
            entries = (dp or None,) + (None,) * (nd - 1)
        else:
            entries = (None,)
        return _fit(mesh, P(*entries), shape)

    return tree_map(one, cache)
