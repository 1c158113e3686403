"""Parameters and caches from the JAX package into this one.

The JAX package's trees arrive as numpy arrays (``np.asarray`` of each
leaf; bf16 leaves come through float32, since numpy has no native bf16).
Layouts are the same on both sides (``wq (D,H,hd)``, ``wk/wv (D,Hkv,hd)``,
``wo (H,hd,D)``, ``w_gate/w_up (D,F)``, ``w_down (F,D)``, stacked layer
leaves), so conversion is leaf by leaf and checks every shape against the
port's own ``init_params`` / ``init_cache`` for the same config.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.torchstate import tree_map
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def _leaf(x, device, dtype):
    arr = np.asarray(x)
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr, np.float32)).to(
            device=device, dtype=dtype)
    return torch.from_numpy(np.array(arr)).to(device)


def _check(got, want, path="") -> None:
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"{path or 'tree'}: keys "
                             f"{sorted(got) if isinstance(got, dict) else got}"
                             f" != {sorted(want)}")
        for k in want:
            _check(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise ValueError(f"{path}: {len(got)} entries != {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            _check(g, w, f"{path}[{i}]")
    elif tuple(got.shape) != tuple(want.shape):
        raise ValueError(f"{path}: shape {tuple(got.shape)} != "
                         f"{tuple(want.shape)}")


def params_from_jax(tree, cfg: ModelConfig, device="cuda", dtype=None):
    """The JAX package's parameter tree (numpy leaves) as this package's,
    on ``device`` in ``dtype`` (default: ``cfg.dtype``)."""
    dev = T.resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    out = tree_map(lambda x: _leaf(x, dev, dtype), tree)
    _check(out, T.init_params(cfg, device="meta"))
    return out


def cache_from_jax(cache, cfg: ModelConfig, device="cuda", dtype=None):
    """The JAX package's decode cache (numpy leaves) as this package's: k/v
    in ``dtype`` on ``device`` and ``length`` as a Python int."""
    dev = T.resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    out = {"layers": tree_map(lambda x: _leaf(x, dev, dtype),
                              cache["layers"]),
           "tail": [], "length": int(np.asarray(cache["length"]))}
    if cache["tail"]:
        raise ValueError("caches with unrolled tail layers are not ported")
    B, S = _cache_dims(out)
    want = T.init_cache(cfg, B, S, device="meta")
    _check(out["layers"], want["layers"], "layers")
    return out


def _cache_dims(cache) -> tuple[int, int]:
    """(batch, cache length S) of a port cache."""
    layers = cache["layers"]
    k = layers["k"] if isinstance(layers, dict) else layers[0]["k"]
    return k.shape[-4], k.shape[-3]
