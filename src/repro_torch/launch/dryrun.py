"""Dry-run: trace one step of every (arch x shape) cell on fake tensors on
the production meshes and extract the roofline inputs (the counterpart of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--multi-pod] [--both] [--mesh 2x4] [--smoke] [--microbatches N]
        [--out artifacts/dryrun_torch] [--skip-existing] [--optimized]
        [--device cuda|cpu]

For each cell this builds the parameters, optimizer state, batch and cache
as fake tensors (``FakeTensorMode``: shapes and dtypes, no data, no
device) and runs the *real* train step (loss, gradients, the optimizer's
in-place update), prefill or serve step (one token against a ``seq``
cache) on them once, and records:

  * ``memory``: per-device argument and output bytes, the local shards
    of the port's ``param_specs`` / ``opt_state_specs`` / ``batch_specs``
    / ``cache_specs`` on the mesh; ``temp_size_in_bytes``, the trace's
    peak of live fake bytes beyond the arguments (an estimate:
    ``memory_note``)
  * ``cost``: ``FlopCounterMode``'s count of the traced aten operators
    plus the kernels' own counts (``kernels/cost.py``), and the bytes
    every operator reads and writes, unfused (as the reference's CPU HLO
    count is), plus the kernels'; per device, the traced total over the
    device count (the reference's calibrated formula; ``cost_raw`` keeps
    the totals)
  * ``kernels``: each kernel's calls, FLOPs and bytes in the step
  * ``collectives``: per-device wire bytes by kind (``collective_bytes``)
    of the collectives the port itself issues in the step
    (``dist/collectives.py``'s calls and DTensor redistributes)

``--device cuda`` (the default) traces the card's path: every kernel call
is recorded, never launched (``kernels.cost.card_path``); ``--device cpu``
traces the plain path.  No card is needed for either.

The mesh is a ``DeviceMesh`` over an in-process fake process group
(``FakeStore``) of the mesh's world size, which ``main`` creates and
destroys.  The port keeps its model tensors replicated on every rank (the
reference's layouts are XLA's partitioner's, which the port does not
have), so the trace is one rank's program: the collectives are only those
of the explicit sharded regions (the MoE's ``moe_shardmap``, the
``decode_shard_s`` decode), and none of XLA's.  A step whose path picks
rows by value has no trace without data: the all-to-all MoE dispatch
(``moe_a2a``, the ``--optimized`` MoE train and prefill cells) selects
each local expert's rows with ``torch.nonzero``, and the trace raises
there (``DynamicOutputShapeException``).  Importing this module creates no
process group and touches no device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.core.torchstate import tree_leaves as state_leaves
from repro_torch.core.torchstate import tree_map
from repro_torch.dist.sharding import (_axis_size, batch_specs, cache_specs,
                                       is_spec, opt_state_specs, param_specs,
                                       rule_flags, set_mesh, set_rule_flags)
from repro_torch.kernels import cost
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_batch_spec, init_cache, init_params
from repro_torch.serve.serve_step import make_prefill, make_serve_step
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

# ring algorithms' wire bytes per result byte, by kind (G: group size)
RING = {"all-gather": lambda G: (G - 1) / G,
        "all-reduce": lambda G: 2.0 * (G - 1) / G,
        "reduce-scatter": lambda G: float(G - 1),
        "all-to-all": lambda G: (G - 1) / G,
        "collective-permute": lambda G: 1.0}


def collective_bytes(records, while_mult: int = 1) -> dict:
    """Per-device *wire* bytes per collective kind from ``(kind, result
    bytes R, group size G, in_loop)`` records, ring algorithms:
      all-reduce: 2(G-1)/G x R   all-gather: (G-1)/G x R_out
      reduce-scatter: (G-1) x R_out   all-to-all: (G-1)/G x R
      collective-permute: R
    A record ``in_loop`` is multiplied by ``while_mult`` (the reference's
    while bodies; a trace of the port issues every call it makes, so its
    records are never in a loop)."""
    out = {kind: 0.0 for kind in RING}
    for kind, nbytes, group, in_loop in records:
        out[kind] += nbytes * RING[kind](group) * (while_mult if in_loop
                                                   else 1)
    return {k: int(v) for k, v in out.items()}


# §Perf-confirmed per-cell optimization policy (the reference's): the
# paper-faithful rules stay the default; --optimized applies these.
SMALL_DENSE = {"qwen3_0_6b", "starcoder2_3b", "gemma_7b", "musicgen_medium",
               "rwkv6_3b", "pixtral_12b"}


def optimized_overrides(arch: str, shape: str) -> dict:
    mode = configs.SHAPES[shape][2]
    ov = {}
    if mode == "decode":
        ov["serve_weights_tp_only"] = True
        if shape != "long_500k":
            ov["decode_shard_s"] = True
    elif mode == "train" and arch in SMALL_DENSE:
        ov["dp_only"] = True
    if arch in ("qwen3_moe_235b", "arctic_480b") and mode != "decode":
        ov["moe_a2a"] = True
    return ov


def input_specs(cfg, shape_name: str):
    """Meta-tensor stand-ins for every model input of the cell."""
    seq, batch, mode = configs.SHAPES[shape_name]
    return build_batch_spec(cfg, batch, seq, mode=mode), (seq, batch, mode)


# ---------------------------------------------------------------------------
#  the trace's instruments
# ---------------------------------------------------------------------------
# collective operators by kind: c10d's (dist/collectives.py) and the
# functional ones (DTensor redistributes)
_COLLECTIVES = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "all_to_all_single": "all-to-all",
}


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _group_size(args) -> int:
    """The size of the process group a collective's arguments name."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, str):                  # a functional collective's
            return dist.get_world_size(_resolve_process_group(a))
        if isinstance(a, torch.ScriptObject):   # c10d's: the group, boxed
            try:
                return int(dist.ProcessGroup.unbox(a).size())
            except (RuntimeError, TypeError):   # another object (ReduceOp)
                continue
    raise ValueError(f"no process group among {[type(a) for a in args]}")


# operators that move no data: allocation and aliasing
_NO_ACCESS = {torch.ops.aten.empty.memory_format,
              torch.ops.aten.empty_strided.default,
              torch.ops.aten.detach.default,
              torch.ops.aten.lift_fresh.default}


class _Trace(TorchDispatchMode):
    """Sums every operator's input and output bytes (views move none),
    keeps the peak of the fake bytes alive beyond ``arguments``' storages,
    and notes each collective as ``(kind, result bytes, group size,
    in_loop=False)``."""

    def __init__(self, arguments):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.live = self.peak = 0
        self.collectives = []
        self._seen = {id(t.untyped_storage()) for t in _tensors(arguments)}

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        kind = _COLLECTIVES.get(func._opname) \
            if func.namespace in ("c10d", "_c10d_functional") else None
        if kind is not None:
            # c10d's write their result into their first argument; the
            # functional ones return it
            result = args[0] if func.namespace == "c10d" else out
            self.collectives.append((kind, _nbytes(result), _group_size(
                list(args) + list(kwargs.values())), False))
        elif not func.is_view and func not in _NO_ACCESS:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        self._track(out)
        return out


def _local_bytes(tree, specs, mesh) -> int:
    """Bytes of this rank's shard of every tensor of ``tree``, laid out by
    ``specs`` (a tree of ``PartitionSpec``s beside it) on ``mesh``."""
    total = 0
    for t, spec in zip(state_leaves(tree),
                       state_leaves(specs, is_leaf=is_spec)):
        n = t.element_size()
        for d, axes in zip(t.shape, tuple(spec) + (None,) * t.dim()):
            n *= d // (_axis_size(mesh, axes) if axes is not None else 1)
        total += n
    return total


def _fake_like(tree):
    """A fake tensor of each meta tensor's shape, strides and dtype (inside
    ``FakeTensorMode``)."""
    return tree_map(lambda t: torch.empty_strided(t.shape, t.stride(),
                                                  dtype=t.dtype), tree)


# ---------------------------------------------------------------------------
#  one cell
# ---------------------------------------------------------------------------
def trace_step(cfg, mode: str, batch: int, seq: int, mesh=None, *,
               opt=None, microbatches: int = 1, device: str = "cuda",
               trace: bool = True) -> dict:
    """Build ``cfg``'s parameters, optimizer state (train), batch and cache
    (decode) as fake tensors, run one step of ``mode`` on them, and return
    the record's measured part: ``params``, ``lower_s`` and, with
    ``trace``, ``compile_s`` (the trace's seconds), ``memory`` (with
    ``argument_bytes``, the argument bytes by part), ``cost_raw``,
    ``cost``, ``kernels``, ``collectives`` and ``traced_ops``.  ``mesh``:
    a ``DeviceMesh`` (the specs' layout and the sharded regions' groups)
    or None; ``opt``: the train step's ``OptConfig``; ``device``: "cuda"
    traces the card's path, "cpu" the plain one."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: want 'cuda' (the card's path) "
                         "or 'cpu' (the plain path)")
    n_dev = math.prod(mesh.shape) if mesh is not None else 1
    t0 = time.time()
    params_meta = init_params(cfg, device="meta")
    batch_meta = build_batch_spec(cfg, batch, seq, mode=mode)
    rec = {"params": sum(t.numel() for t in tree_leaves(params_meta))}
    with FakeTensorMode() as fake:
        params = _fake_like(params_meta)
        inputs = _fake_like(batch_meta)
        if mode == "train":
            state = init_opt_state(opt, params)
            step = make_train_step(cfg, opt, mesh=mesh,
                                   microbatches=microbatches)
            args = (params, state, inputs)
        elif mode == "prefill":
            state = None
            step = make_prefill(cfg, mesh=mesh)
            args = (params, inputs)
        else:
            state = init_cache(cfg, batch, seq, device="cpu",
                               mesh=mesh if cfg.decode_shard_s else None)
            step = make_serve_step(cfg, mesh=mesh)
            inputs = {"tokens": inputs["tokens"]}
            args = (params, state, inputs["tokens"])
    rec["lower_s"] = round(time.time() - t0, 2)
    if not trace:
        return rec

    t1 = time.time()
    counter = _Trace(args)
    card = cost.card_path() if device == "cuda" else contextlib.nullcontext()
    with fake, card, cost.recording() as calls, \
            FlopCounterMode(display=False) as flops, counter:
        out = step(*args)
    rec["compile_s"] = round(time.time() - t1, 2)

    def local(tree, specs_of):
        if mesh is None:
            return _nbytes(tree)
        return _local_bytes(tree, specs_of(tree), mesh)

    parts = {"params": local(params, lambda t: param_specs(mesh, t)),
             "batch": local(inputs, lambda t: batch_specs(mesh, t))}
    if mode == "train":
        parts["opt_state"] = local(
            state, lambda t: opt_state_specs(mesh, t, params))
        out_bytes = parts["params"] + parts["opt_state"] + _nbytes(out[2])
    elif mode == "prefill":
        out_bytes = local(list(out), lambda t: batch_specs(mesh, t))
    else:
        cache = {k: v for k, v in state.items() if k != "length"}
        parts["cache"] = local(cache, lambda t: cache_specs(mesh, t))
        out_bytes = parts["cache"] + parts["batch"]
    rec["memory"] = {"argument_size_in_bytes": int(sum(parts.values())),
                     "output_size_in_bytes": int(out_bytes),
                     "temp_size_in_bytes": int(counter.peak),
                     "generated_code_size_in_bytes": 0,
                     "argument_bytes": parts}
    rec["memory_note"] = (
        "argument and output bytes: this rank's shards of the port's specs "
        "on the mesh; temp: an estimate, the trace's peak of live fake "
        "bytes beyond the arguments, on one rank, whose model tensors are "
        "replicated")
    kernels = cost.by_kernel(calls)
    total_flops = flops.get_total_flops() + sum(k["flops"]
                                                for k in kernels.values())
    total_bytes = counter.bytes + sum(k["bytes"] for k in kernels.values())
    rec["cost_raw"] = {"flops": float(total_flops),
                       "bytes accessed": float(total_bytes),
                       "aten_flops": float(flops.get_total_flops()),
                       "aten_bytes": float(counter.bytes)}
    rec["cost"] = {"flops": total_flops / n_dev,
                   "bytes_accessed": total_bytes / n_dev,
                   "calibrated": True}
    rec["kernels"] = kernels
    rec["collectives"] = collective_bytes(counter.collectives)
    rec["collective_calls"] = len(counter.collectives)
    rec["traced_ops"] = counter.ops
    return rec


def lower_cell(arch: str, shape_name: str, mesh, *, opt_name: str | None = None,
               smoke: bool = False, compile_: bool = True,
               microbatches: int = 1, verbose: bool = True,
               calibrate: bool = True, overrides: dict | None = None,
               device: str = "cuda") -> dict:
    """Trace one cell's step on fake tensors (``trace_step``) and return
    its record.

    ``compile_=False`` stops after building the fake state (no trace; the
    record has no ``memory``, ``cost`` or ``collectives``).  ``calibrate``
    is accepted for the reference's signature and has nothing to do: the
    reference extrapolates from 1- and 2-layer variants because XLA's cost
    analysis counts a scan body once, while the trace runs every layer.
    ``device``: "cuda" traces the card's path, "cpu" the plain one."""
    cfg = configs.smoke(arch) if smoke else configs.get(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    _, (seq, batch, mode) = input_specs(cfg, shape_name)
    if smoke:
        seq, batch = min(seq, 256), min(batch, max(8, 1))
    opt = OptConfig(name=opt_name or
                    ("adafactor" if arch == "arctic_480b" else "adamw"))
    flags = rule_flags()
    set_rule_flags(ulysses=cfg.ulysses,
                   serve_weights=cfg.serve_weights_tp_only,
                   dp_only=cfg.dp_only)
    set_mesh(mesh)
    try:
        rec = {"arch": arch, "shape": shape_name, "mode": mode,
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))
               if mesh is not None else {},
               "seq": seq, "batch": batch,
               "active_params": cfg.active_param_count(), "device": device}
        rec.update(trace_step(cfg, mode, batch, seq, mesh, opt=opt,
                              microbatches=microbatches, device=device,
                              trace=compile_))
    finally:
        set_mesh(None)
        set_rule_flags(**flags)
    if verbose and compile_:
        kernels = {k: v["launches"] for k, v in rec["kernels"].items()}
        print(f"  [{arch} x {shape_name}] lower {rec['lower_s']}s "
              f"trace {rec['compile_s']}s flops/dev "
              f"{rec['cost']['flops']:.3e} "
              f"coll {sum(rec['collectives'].values()) / 1e6:.1f}MB "
              f"kernels {kernels}")
    return rec


# ---------------------------------------------------------------------------
#  the fake process group and the CLI
# ---------------------------------------------------------------------------
def init_fake_group(world_size: int) -> None:
    """An in-process fake process group of ``world_size`` ranks (this
    process is rank 0): collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _cells(arch, shape):
    cells = configs.cells()
    if arch:
        key = configs.ALIASES.get(arch,
                                  arch.replace("-", "_").replace(".", "_"))
        cells = [c for c in cells if c[0] == key]
    if shape:
        cells = [c for c in cells if c[1] == shape]
    return cells


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true",
                    help="run single-pod AND multi-pod")
    ap.add_argument("--mesh", default=None,
                    help="override mesh, e.g. 2x4 (axes data,model) or "
                    "2x2x2 (pod,data,model)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the §Perf-confirmed per-cell flags; artifacts"
                    " are tagged _opt")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="trace the card's path (kernels recorded) or the "
                    "plain one")
    args = ap.parse_args(argv)

    cells = _cells(args.arch, args.shape)
    if not cells:
        raise SystemExit("no cells selected")

    if args.mesh:
        dims = tuple(int(x) for x in args.mesh.split("x"))
        meshes = [("custom", dims, ("pod", "data", "model")[-len(dims):])]
    else:
        pod1 = ("pod1", (16, 16), ("data", "model"))
        pod2 = ("pod2", (2, 16, 16), ("pod", "data", "model"))
        meshes = [pod1, pod2] if args.both else \
            [pod2] if args.multi_pod else [pod1]

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = []
    for mesh_name, dims, axes in meshes:
        init_fake_group(math.prod(dims))
        try:
            mesh = make_mesh(dims, axes)
            for arch, shape in cells:
                tag = f"{arch}_{shape}_{mesh_name}" \
                    + ("_opt" if args.optimized else "") \
                    + ("_smoke" if args.smoke else "")
                if args.skip_existing and (outdir / f"{tag}.json").exists():
                    print(f"== {tag} (cached)")
                    continue
                print(f"== {tag} (mesh {dict(zip(axes, dims))})")
                try:
                    ov = optimized_overrides(arch, shape) if args.optimized \
                        else None
                    rec = lower_cell(arch, shape, mesh, smoke=args.smoke,
                                     microbatches=args.microbatches,
                                     overrides=ov, device=args.device)
                    print(json.dumps({k: rec[k] for k in
                                      ("memory", "cost", "collectives")
                                      if k in rec}, indent=None)[:400])
                    (outdir / f"{tag}.json").write_text(
                        json.dumps(rec, indent=1))
                except Exception as e:
                    import traceback
                    traceback.print_exc()
                    failures.append((tag, repr(e)))
        finally:
            dist.destroy_process_group()
    if failures:
        print(f"\nFAILED {len(failures)} cells:")
        for tag, err in failures:
            print(f"  {tag}: {err[:200]}")
        raise SystemExit(1)
    print(f"\nALL {len(cells) * len(meshes)} cells OK")


if __name__ == "__main__":
    main()
