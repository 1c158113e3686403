"""Color-versioned checkpointing (the counterpart of
``repro.checkpoint.checkpoint``).

DRust's fault-tolerance design (§4.2.3) applied to training state:

  * write-backs are batched per ownership epoch: the checkpoint hook fires
    at the train step's mutable-borrow drop, and only every
    ``every_n_epochs``;
  * the checkpoint is addressed by the state's colored address: restore
    resumes the exact write epoch (no torn state).

Format, the reference's to the byte of its manifest: one ``.npz`` per
snapshot plus a JSON manifest (leaf paths, shapes, dtypes, color, step).
A leaf's path joins its dict keys and list/tuple indices with ``/``, as
``jax.tree_util.tree_flatten_with_path`` names them, so a checkpoint
written by either package restores in the other.  bf16 leaves are stored
as float32 (numpy has no bf16), as the reference does.

``quantize=True`` stores large float leaves int8 on disk
(``dist.compression.quantize_int8``: symmetric per-tensor scale,
``|x - q*scale| <= scale/2`` up to float32 rounding, checked at save time
against ``error_bound``) and dequantizes them on restore; small leaves
(norms, scalars, integer steps) stay exact.

Restoring onto a mesh of devices waits for the multi-device slice (ROADMAP
Queue 1 item 10).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.core.torchstate import ColoredAddr, OwnedState, tree_map
from repro_torch.dist.compression import (dequantize_int8, error_bound,
                                          quantize_int8)


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """{path: leaf} in the reference's path format; ``None`` is an empty
    subtree, as in JAX."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif tree is None:
        return {}
    else:
        return {prefix: tree}
    out: dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _no_mesh(mesh, specs) -> None:
    if mesh is not None or specs is not None:
        raise NotImplementedError(
            "restoring onto a mesh: multi-device support is ROADMAP Queue 1 "
            "item 10")


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array; bf16 as float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(leaf)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def save(path: str | Path, tree: Any, *, color: int = 0, step: int = 0,
         extra: dict | None = None, quantize: bool = False,
         min_quant_size: int = 64) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {}
    manifest_leaves = {}
    for k, v in _flatten(tree).items():
        a = _host(v)
        entry = {"shape": list(a.shape), "dtype": str(a.dtype)}
        if quantize and a.dtype.kind == "f" and a.size >= min_quant_size:
            q, scale = quantize_int8(torch.from_numpy(a))
            q, scale = q.numpy(), np.asarray(scale.numpy(), np.float32)
            # the on-disk value may never be more than half a quantization
            # step (and float32 rounding) from the live one
            err = float(np.max(np.abs(a.astype(np.float64)
                                      - q.astype(np.float64) * scale)))
            if err > error_bound(scale):
                raise RuntimeError(f"{k}: int8 checkpoint error {err} "
                                   f"exceeds scale/2 = {float(scale) / 2}")
            arrays[k + "::q"] = q
            arrays[k + "::scale"] = scale
            entry["quantized"] = True
        else:
            arrays[k] = a
        manifest_leaves[k] = entry
    np.savez(str(path) + ".npz", **arrays)
    manifest = {
        "color": color, "step": step,
        "leaves": manifest_leaves,
        "extra": extra or {},
    }
    Path(str(path) + ".json").write_text(json.dumps(manifest, indent=1))
    return path


def restore(path: str | Path, like: Any, *, mesh=None, specs=None) -> tuple:
    """Restore into the structure of ``like`` (a tree of tensors, ``meta``
    ones included, whose dtypes and devices the restored leaves take; a
    ``meta`` leaf comes back on the CPU).  Returns (tree, manifest)."""
    _no_mesh(mesh, specs)
    path = Path(path)
    manifest = json.loads(Path(str(path) + ".json").read_text())
    with np.load(str(path) + ".npz") as data:
        def one(k, ref):
            if manifest["leaves"].get(k, {}).get("quantized"):
                t = dequantize_int8(torch.from_numpy(data[k + "::q"]),
                                    torch.from_numpy(data[k + "::scale"]))
            else:
                t = torch.from_numpy(np.array(data[k]))
            dev = "cpu" if ref.device.type == "meta" else ref.device
            return t.to(device=dev, dtype=ref.dtype)
        out = {k: one(k, ref) for k, ref in _flatten(like).items()}
    it = iter(out.values())
    restored = tree_map(lambda x: None if x is None else next(it), like)
    return restored, manifest


class CheckpointManager:
    """Epoch-batched checkpointing for an ``OwnedState``: a snapshot at the
    borrow drop of every ``every_n_epochs``-th epoch, the newest ``keep``
    kept."""

    def __init__(self, directory: str | Path, state: OwnedState,
                 every_n_epochs: int = 1, keep: int = 3,
                 quantize: bool = False):
        self.dir = Path(directory)
        self.state = state
        self.every = every_n_epochs
        self.keep = keep
        self.quantize = quantize           # int8 on disk, exact manifest
        self.saved: list[tuple[int, Path]] = []
        state.on_epoch.append(self._hook)

    def _hook(self, addr: ColoredAddr, tree: Any) -> None:
        if addr.color % self.every != 0:
            return
        p = self.dir / f"ckpt_{addr.color:08d}"
        save(p, tree, color=addr.color, step=addr.color,
             quantize=self.quantize)
        self.saved.append((addr.color, p))
        while len(self.saved) > self.keep:
            _, old = self.saved.pop(0)
            for suffix in (".npz", ".json"):
                Path(str(old) + suffix).unlink(missing_ok=True)

    def latest(self) -> tuple[int, Path] | None:
        return self.saved[-1] if self.saved else None

    def restore_latest(self, like: Any, mesh=None, specs=None):
        if not self.saved:
            raise FileNotFoundError("no checkpoints saved")
        color, p = self.saved[-1]
        tree, manifest = restore(p, like, mesh=mesh, specs=specs)
        self.state._tree = tree
        self.state.addr = ColoredAddr(self.state.addr.name, manifest["color"])
        return tree, manifest
