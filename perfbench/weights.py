"""Random weights from the seed, made on the device by the benchmark.

A configuration file lists its leaves (``"leaves"``): path, dtype, the
shape of one layer, and the init: a standard deviation, ``"zeros"``, or
``"fan_in:i,j"`` (the standard deviation one over the root of the
product of those dims of the layer's shape).  A leaf whose first path
component names a stack of ``stacks`` (the file's ``"stacks"``: {first
path component: layers}, by default {"layers": n_layers}) is stacked over
that stack's layers, as the port keeps them; any other leaf is drawn
once.

Each layer slice of each leaf is drawn by its own generator, seeded from
(seed, path, layer), so any slice can be drawn again alone: the
reference and the change of the parameters over the first steps take
the starting weights slice by slice, with no second copy of the model.
"""

from __future__ import annotations

import math
import zlib

import torch


def _std(init, shape) -> float:
    if isinstance(init, (int, float)):
        return float(init)
    if init == "zeros":
        return 0.0
    if isinstance(init, str) and init.startswith("fan_in:"):
        dims = [int(i) for i in init[len("fan_in:"):].split(",")]
        return math.prod(shape[i] for i in dims) ** -0.5
    raise ValueError(f"unknown init {init!r}")


def slice_seed(seed: int, path: str, layer: int) -> int:
    """A 63-bit seed of one layer slice of one leaf."""
    return (seed * 1_000_003 + zlib.crc32(path.encode()) * 4099
            + layer) % (1 << 63)


def stacks(config: dict) -> dict:
    """{first path component: layers} of a config's stacked leaves."""
    out = config.get("stacks", {"layers": config["model"]["n_layers"]})
    for name, n in out.items():
        if type(n) is not int or n < 1:
            raise ValueError(f"stack {name!r} has {n!r} layers")
    return out


def _stacked(st: dict, path: str) -> int:
    """The layers of the stack ``path`` belongs to, or 0."""
    return st.get(path.split(".")[0], 0)


def leaves(config: dict):
    """[(path, dtype, per-layer shape, std, layers or 0)] of a config."""
    st = stacks(config)
    return [(path, getattr(torch, dtype), tuple(shape), _std(init, shape),
             _stacked(st, path))
            for path, (dtype, shape, init) in config["leaves"].items()]


def draw(config: dict, seed: int, path: str, layer: int, device,
         out=None):
    """Layer ``layer`` of leaf ``path`` (layer 0 of an unstacked leaf),
    in the leaf's dtype on ``device``, written into ``out`` if given."""
    spec = {p: (dt, shape, std) for p, dt, shape, std, _ in leaves(config)}
    dtype, shape, std = spec[path]
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=device)
    if std == 0.0:
        return out.zero_()
    gen = torch.Generator(device=out.device)
    gen.manual_seed(slice_seed(seed, path, layer))
    return out.normal_(0.0, std, generator=gen)


def distance_sq(a, b, block: int = 1 << 26) -> float:
    """||a - b||^2 in float64, over blocks of about ``block`` elements,
    one read back to the host."""
    a, b = a.reshape(-1), b.reshape(-1)
    total = torch.zeros((), dtype=torch.float64, device=a.device)
    for i in range(0, a.numel(), block):
        d = a[i:i + block].double() - b[i:i + block].double()
        total += d.square().sum()
    return float(total)


def change_norms(config: dict, seed: int, slices: dict) -> dict:
    """{path: ||the slices now - the seed's starting weights||} of
    {path: [one tensor a layer]}, the starting weights drawn again a slice
    at a time."""
    with torch.no_grad():
        return {path: math.sqrt(sum(
            distance_sq(t, draw(config, seed, path, j, t.device))
            for j, t in enumerate(ts))) for path, ts in slices.items()}


def row_means_sq(slices: dict, scale: float = 1.0) -> dict:
    """{path: the mean over the last dim of (scale t)^2, for each row of
    each layer's tensor t in turn} of {path: [one tensor a layer]}, as a
    float64 vector on the host."""
    out = {}
    with torch.no_grad():
        for path, ts in slices.items():
            out[path] = torch.cat([
                (torch.linalg.vector_norm(t.float(), dim=-1).double()
                 .square() * (scale ** 2 / t.shape[-1])).reshape(-1).cpu()
                for t in ts])
    return out


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *parents, last = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = t
    return tree


def program_params(config: dict, seed: int, device) -> dict:
    """The parameter tree as the port takes it: a stacked leaf
    ``(layers, ...)``, an empty ``tail``."""
    flat = {}
    for path, dtype, shape, _, n in leaves(config):
        t = torch.empty(((n,) if n else ()) + shape, dtype=dtype,
                        device=device)
        for j in range(max(n, 1)):
            draw(config, seed, path, j, device, out=t[j] if n else t)
        flat[path] = t
    tree = _nest(flat)
    tree["tail"] = []
    return tree


def reference_params(config: dict, seed: int, device) -> dict:
    """The same weights in float32 as {path: [one tensor a layer]} (one
    tensor for an unstacked leaf in a list of one), each its own leaf."""
    out = {}
    for path, _, _, _, n in leaves(config):
        out[path] = [draw(config, seed, path, j, device).float()
                     for j in range(max(n, 1))]
    return out


def layer_slices(config: dict, tree: dict) -> dict:
    """{path: [one tensor a layer]} of a port tree: a stacked leaf's
    layers as views, an unstacked leaf in a list of one (the layout of
    ``reference_params``)."""
    st = stacks(config)
    return {path: list(t.unbind(0)) if _stacked(st, path) else [t]
            for path, t in flat_program(tree).items()}


def layer_params(params: dict, stack: str, j: int) -> dict:
    """{path below the stack: tensor} of layer ``j`` of the stack
    ``stack`` in {path: [one tensor a layer]}."""
    head = stack + "."
    return {path[len(head):]: ts[j] for path, ts in params.items()
            if path.startswith(head)}


def flat_program(tree: dict, prefix: str = "") -> dict:
    """{path: tensor} of a port tree (dicts only; ``tail`` empty)."""
    out = {}
    for key, v in tree.items():
        path = f"{prefix}{key}"
        if isinstance(v, dict):
            out.update(flat_program(v, path + "."))
        elif isinstance(v, torch.Tensor):
            out[path] = v
        elif v:
            raise ValueError(f"{path}: a non-empty {type(v).__name__}")
    return out
