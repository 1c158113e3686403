"""Parameters and caches from the JAX package into this one.

The JAX package's trees arrive as numpy arrays (``np.asarray`` of each
leaf; bf16 leaves come through float32, since numpy has no native bf16).
Layouts are the same on both sides (``wq (D,H,hd)``, ``wk/wv (D,Hkv,hd)``,
``wo (H,hd,D)``, ``w_gate/w_up (D,F)``, ``w_down (F,D)``, stacked layer
leaves, lists of per-position stacks for hybrids, unrolled tails), so
conversion is leaf by leaf: each leaf takes the dtype of the port's own
``init_params`` / ``init_cache`` leaf for the same config (so the float32
leaves of a bf16 model — RWKV's ``u`` and ``w0``, RG-LRU's ``lam``, the
recurrent states — stay float32), and every shape and dtype is checked
against that tree.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def _leaf(x, want, device):
    arr = np.asarray(x)
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        arr = np.array(arr, np.float32)
    return torch.from_numpy(np.array(arr)).to(device=device,
                                              dtype=want.dtype)


def _convert(got, want, device, path=""):
    """``got`` (numpy leaves) as tensors in the structure, shapes and dtypes
    of ``want``; raises ``ValueError`` naming the first leaf that differs."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"{path or 'tree'}: keys "
                             f"{sorted(got) if isinstance(got, dict) else got}"
                             f" != {sorted(want)}")
        return {k: _convert(got[k], want[k], device, f"{path}/{k}")
                for k in want}
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise ValueError(f"{path}: {got!r:.40} is not a list of "
                             f"{len(want)} entries")
        return [_convert(g, w, device, f"{path}[{i}]")
                for i, (g, w) in enumerate(zip(got, want))]
    if tuple(np.shape(got)) != tuple(want.shape):
        raise ValueError(f"{path}: shape {tuple(np.shape(got))} != "
                         f"{tuple(want.shape)}")
    return _leaf(got, want, device)


def params_from_jax(tree, cfg: ModelConfig, device="cuda"):
    """The JAX package's parameter tree (numpy leaves) as this package's,
    on ``device``."""
    dev = T.resolve_device(device)
    return _convert(tree, T.init_params(cfg, device="meta"), dev)


def cache_from_jax(cache, cfg: ModelConfig, device="cuda"):
    """The JAX package's decode cache (numpy leaves) as this package's, on
    ``device``, with ``length`` as a Python int."""
    dev = T.resolve_device(device)
    B, S = _cache_dims(cache)
    want = T.init_cache(cfg, B, S, device="meta")
    return {"layers": _convert(cache["layers"], want["layers"], dev,
                               "layers"),
            "tail": _convert(cache["tail"], want["tail"], dev, "tail"),
            "length": int(np.asarray(cache["length"]))}


def _cache_dims(cache) -> tuple[int, int]:
    """(batch, attention cache length S, or 1 without attention) of a
    cache tree, read from its layers' leaves: k (..., B, S, Hkv, hd),
    S (..., B, H, M, M) or h (..., B, dl)."""
    layers = cache["layers"]
    caches = (layers if isinstance(layers, list) else [layers]) \
        + list(cache["tail"])
    for c in caches:
        if "k" in c:
            k = np.shape(c["k"])
            return k[-4], k[-3]
    c = caches[0]
    return (np.shape(c["S"])[-4] if "S" in c else np.shape(c["h"])[-2]), 1
