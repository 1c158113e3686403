"""Device meshes over a process group, and a launcher of local ranks (the
counterpart of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims.
Building one needs an initialised process group whose world size is the
product of the mesh's shape: one rank per card with NCCL, or one rank per
process with gloo on the CPU.  ``spawn`` starts such ranks on this host,
the port's counterpart of the reference's
``--xla_force_host_platform_device_count`` (several CPU "devices" in one
host).  Importing this module starts nothing.
"""

from __future__ import annotations

import math
import os
import pickle
import queue
import tempfile
import time
import traceback


def make_mesh(shape, axes, device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    process group, on ``device_type`` (``cuda`` under NCCL, else ``cpu``,
    when None).  Raises unless the world size is the product of
    ``shape``: a smaller mesh is never built quietly."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or "
                           "launch.mesh.spawn)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; the "
                         f"process group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks when ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def _worker(payload_path, rank, world_size, backend, store_path, results):
    import torch
    import torch.distributed as dist
    try:
        with open(payload_path, "rb") as f:
            fn, args = pickle.load(f)             # written by spawn
        if backend == "gloo":
            torch.set_num_threads(1)        # one CPU "device" a process
        else:
            torch.cuda.set_device(rank)
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                          # reported to the parent
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world_size: int, *args, backend: str = "gloo",
          timeout: float = 300.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` new processes, each one rank of
    a fresh ``backend`` process group (rank ``r`` on card ``r`` under
    NCCL), and return each rank's result, by rank.  ``fn`` must be
    importable by name and its result picklable (numpy arrays, not
    tensors).  The ranks meet through a ``FileStore`` in a new temporary
    directory, so concurrent launches never share a port.  Raises, with
    the rank's traceback, if a rank fails, and ``TimeoutError`` if the
    ranks have not all finished within ``timeout`` seconds."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as d:
        # fn and args go through a file: a process start writes its
        # arguments into a pipe that the child reads only once it runs, so
        # large ones would make each start wait for the one before
        payload = os.path.join(d, "payload.pkl")
        with open(payload, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_worker,
                             args=(payload, r, world_size, backend,
                                   os.path.join(d, "store"), results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out: dict = {}
        deadline = time.monotonic() + timeout
        done = False
        try:
            while len(out) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world_size - len(out)} of "
                                       f"{world_size} ranks did not finish "
                                       f"within {timeout} s")
                try:
                    rank, ok, val = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a rank exited with code "
                                           f"{dead[0]} before reporting")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} "
                                       f"failed:\n{val}")
                out[rank] = val
            done = True
        finally:
            # after a failure the other ranks may wait in a collective for
            # ever: end them at once
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic())
                       if done else 1.0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
    return [out[r] for r in range(world_size)]
