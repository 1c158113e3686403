"""Elastic scaling: checkpoint reshard and live protocol-runtime rescale
(the counterpart of ``repro.launch.elastic``).

    PYTHONPATH=src python -m repro_torch.launch.elastic --arch qwen3-0.6b \\
        --from-mesh 2x4 --to-mesh 4x2
    PYTHONPATH=src python -m repro_torch.launch.elastic --protocol \\
        [--servers 4]

Two paths to the same DSM promise (the global address space stays fixed
while the membership changes):

* **checkpoint reshard** (default): checkpoints store logical
  (path -> global shape) leaves, so restoring onto any mesh is a
  re-partition.  The parameters are laid out on a ``(data, model)`` mesh
  as ``DTensor``s, saved, and restored onto another mesh of the same
  ranks.  Without ``WORLD_SIZE`` in the environment the CLI starts its
  own gloo ranks on this host (``launch.mesh.spawn``); under ``torchrun``
  it joins the group torchrun set up.
* **live protocol rescale** (``--protocol``): a server *crashes* under a
  live drust runtime (shrink), the controller's probe loop declares it and
  the ``RecoveryManager`` fails it over (quiesce / re-home / restripe —
  flushed data stays readable at its original addresses), then the
  cluster *grows* with ``add_server`` and keeps allocating on the new
  member.  Everything runs on the simulator's virtual clocks.
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import sys
import tempfile

from repro_torch.core import Cluster, ServerLostError


def run(arch: str = "qwen3-0.6b", from_mesh=(2, 4), to_mesh=(4, 2),
        verbose: bool = True) -> bool:
    """Lay ``arch``'s smoke-size parameters out on a ``from_mesh``
    ``(data, model)`` mesh by ``param_specs``, save them at epoch color 3,
    restore them onto ``to_mesh`` by its specs, and check that every leaf
    equals the unsharded parameters, takes its spec's placements, and that
    the color survived.  Every rank of the initialised process group
    (``prod(from_mesh)`` = ``prod(to_mesh)`` of them) calls this; rank 0
    prints the reference's line when ``verbose``.  Returns the verdict of
    every rank together."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.checkpoint import restore, save
    from repro_torch.core.torchstate import tree_leaves
    from repro_torch.dist.sharding import (is_spec, param_specs, place,
                                           to_placements)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params

    from_mesh, to_mesh = tuple(from_mesh), tuple(to_mesh)
    if math.prod(from_mesh) != math.prod(to_mesh):
        raise ValueError(f"meshes {from_mesh} and {to_mesh} differ in size")
    cfg = configs.smoke(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    mesh_a = make_mesh(from_mesh, ("data", "model"))
    dev = mesh_a.device_type
    sharded_a = place(params, param_specs(mesh_a, params), mesh_a)

    d = [tempfile.mkdtemp(prefix="repro_torch_elastic_")
         if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(d, src=0)
    try:
        save(f"{d[0]}/ck", sharded_a, color=3)
        mesh_b = make_mesh(to_mesh, ("data", "model"))
        like = init_params(cfg, device="meta")
        specs_b = param_specs(mesh_b, like)
        restored, manifest = restore(f"{d[0]}/ck", like, mesh=mesh_b,
                                     specs=specs_b)
        ok = manifest["color"] == 3
        for a, b, spec in zip(tree_leaves(params), tree_leaves(restored),
                              tree_leaves(specs_b, is_leaf=is_spec)):
            ok &= tuple(b.placements) == tuple(to_placements(mesh_b, spec))
            ok &= _same(b, a)
        flag = torch.tensor([int(ok)], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        ok = bool(flag.item())
        dist.barrier()
    finally:
        if dist.get_rank() == 0:
            shutil.rmtree(d[0], ignore_errors=True)
    if verbose and dist.get_rank() == 0:
        verdict = "OK" if ok else "MISMATCH"
        print(f"elastic reshard {from_mesh} -> {to_mesh}: {verdict} "
              f"(epoch color {manifest['color']})", flush=True)
    return ok


def _same(shard, full) -> bool:
    """Whether a DTensor's local shard equals the same shard of the
    unsharded ``full`` (every rank checks its own: no communication)."""
    from torch.distributed.tensor import distribute_tensor
    want = distribute_tensor(full.to(shard.device), shard.device_mesh,
                             shard.placements, src_data_rank=None)
    return bool((shard.to_local() == want.to_local()).all())


def rescale(n_servers: int = 4):
    """Crash server ``n-1``, probe-detect and fail it over, check that
    flushed data survives at its original addresses and the unflushed
    write is lost, then grow by one server and allocate on it.  Returns
    ``(ok, cluster, report)``, the ``RecoveryReport`` of the fail-over."""
    cl = Cluster(n_servers, "drust", replicate=True, qps_per_thread=2,
                 ooo=True, coalesce="auto")
    ths = [cl.main_thread(s) for s in range(n_servers)]
    victim = n_servers - 1

    # Populate every server, mutate, and flush the epoch (train-step edge).
    boxes = []
    for s, th in enumerate(ths):
        for i in range(8):
            b = cl.backend.alloc(th, 256, i + 100 * s, server=s)
            cl.backend.write(th, b, i + 1000 * s)
            boxes.append((s, i, b))
    cl.replicator.flush_epoch()
    dirty = cl.backend.alloc(ths[victim], 256, "dirty", server=victim)
    cl.backend.write(ths[victim], dirty, "unflushed")    # will be lost

    # Shrink: crash + probe loop until declared, recovery runs.
    cl.recovery.crash(victim)
    probe_th = ths[0]
    declared: list = []
    while not declared:
        declared = cl.controller.probe_failures(probe_th)
    report = cl.recovery.reports[-1]
    ok = declared == [victim] and report.server == victim
    ok &= report.rehomed_boxes >= 8 and report.lost_writes >= 1

    # Flushed data is readable at its original addresses, served by the
    # promoted backup; the unflushed write reverted to its flushed epoch.
    for s, i, b in boxes:
        ok &= cl.backend.read(ths[0], b) == i + 1000 * s
    try:
        cl.backend.read(ths[0], dirty)
        got_lost = True          # restored from replica map?  It never flushed
    except ServerLostError:
        got_lost = False
    ok &= not got_lost

    # Grow: a fresh server joins and takes allocations + traffic.
    s_new = cl.add_server()
    th_new = cl.main_thread(s_new)
    nb = cl.backend.alloc(th_new, 256, "fresh", server=s_new)
    ok &= cl.backend.read(ths[0], nb) == "fresh"
    ok &= s_new == n_servers and len(cl.sim.alive_servers()) == n_servers
    return bool(ok), cl, report


def report_line(n_servers: int, ok: bool, report) -> str:
    """The reference's one-line report of a rescale."""
    return (f"elastic protocol rescale {n_servers}->"
            f"{n_servers - 1}->{n_servers}: {'OK' if ok else 'MISMATCH'} "
            f"(rehomed {report.rehomed_boxes}, orphans "
            f"{report.orphaned_cids}, makespan "
            f"{report.makespan_us:.1f}us)")


def run_protocol(n_servers: int = 4, verbose: bool = True) -> bool:
    """Live rescale of a running protocol cluster (``rescale``); prints
    the reference's report line when ``verbose``."""
    ok, _, report = rescale(n_servers)
    if verbose:
        print(report_line(n_servers, ok, report))
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--from-mesh", default="2x4")
    ap.add_argument("--to-mesh", default="4x2")
    ap.add_argument("--protocol", action="store_true",
                    help="live protocol-runtime rescale (crash + fail-over "
                         "+ grow) instead of a checkpoint reshard")
    ap.add_argument("--servers", type=int, default=4)
    a = ap.parse_args(argv)
    if a.protocol:
        return 0 if run_protocol(a.servers) else 1

    def parse(s):
        return tuple(int(x) for x in s.split("x"))
    src, dst = parse(a.from_mesh), parse(a.to_mesh)
    if math.prod(src) != math.prod(dst):
        raise ValueError(f"meshes {src} and {dst} differ in size")
    if "WORLD_SIZE" in os.environ:                  # under torchrun
        import torch
        import torch.distributed as dist
        if torch.cuda.is_available():
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo")
        try:
            ok = run(a.arch, src, dst)
        finally:
            dist.destroy_process_group()
        return 0 if ok else 1
    from repro_torch.launch.mesh import spawn
    return 0 if all(spawn(run, math.prod(src), a.arch, src, dst)) else 1


if __name__ == "__main__":
    sys.exit(main())
