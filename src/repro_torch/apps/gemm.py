"""GEMM (§7.1): blocked divide-and-conquer matmul over the shared heap.

A, B are tiled into T×T blocks stored as heap objects, spread round-robin
over the servers' partitions.  Workers own contiguous ranges of output
tiles; for C[i,j] a worker reads the A[i,:] row tiles and B[:,j] column
tiles (immutable → cacheable) and writes C[i,j] locally.  High compute
intensity (Table 1: ~300 cycles/byte) means protocols that cache
sub-matrices (DRust, GAM) scale; always-delegating Grappa does not
(Fig. 5c: 5.93× / 3.82× / 2.02× at 8 nodes).

The numerics are real: the tiles are float32 tensors on ``device``, each
tile product is a ``torch.matmul`` there, and the distributed result is
asserted against the single-shot ``A @ B`` oracle on the same device on
every run.  A and B are drawn exactly as ``repro.apps.gemm`` draws them
(numpy, ``seed``), so the simulated run — ops, makespan, ``NetStats`` —
is the reference's, on any device.

``prefetch=True`` (drust only) posts a speculative fetch of the A-row and
B-column tiles before each output tile's k-loop: the read doorbells go out
while the first MACs run, and each tile deref pays only the deferred
completion fence (``late_fences``) instead of a synchronous round trip.
Tiles are immutable here, so no prefetch is ever wasted — the staleness
machinery (``wasted_prefetches``) stays at zero by construction.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import resolve_device
from .common import AppResult, make_cluster, spread_threads

FLOPS_PER_CYCLE = 16.0          # AVX2 sgemm-ish per core


def run_gemm(n_servers: int, backend: str = "drust", n: int = 1024,
             tile: int = 128, workers_per_server: int = 4,
             cores: int = 16, seed: int = 0, prefetch: bool = False,
             check: bool = True, device="cuda",
             out: torch.Tensor | None = None) -> AppResult:
    """``out``, when given, is an (n, n) float32 tensor on ``device`` that
    receives the product."""
    dev = resolve_device(device)
    cl = make_cluster(n_servers, backend, cores)
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(
        rng.standard_normal((n, n)).astype(np.float32)).to(dev)
    B = torch.from_numpy(
        rng.standard_normal((n, n)).astype(np.float32)).to(dev)
    nt = n // tile
    tile_bytes = tile * tile * 4

    boot = cl.main_thread(0)
    a_h, b_h = {}, {}
    for i in range(nt):
        for k in range(nt):
            a_h[(i, k)] = cl.backend.alloc(
                boot, tile_bytes, A[i*tile:(i+1)*tile, k*tile:(k+1)*tile].clone(),
                server=(i * nt + k) % n_servers)
            b_h[(k, i)] = cl.backend.alloc(
                boot, tile_bytes, B[k*tile:(k+1)*tile, i*tile:(i+1)*tile].clone(),
                server=(k * nt + i + 1) % n_servers)
    boot.t_us = 0.0                       # setup off the measured path
    for s in cl.sim.servers:
        s.cpu_busy_us = 0.0

    ths = spread_threads(cl, workers_per_server)
    if out is None:
        out = torch.zeros((n, n), dtype=torch.float32, device=dev)
    tiles = [(i, j) for i in range(nt) for j in range(nt)]
    # contiguous row-major ranges per worker: A-row / B-column tile reuse
    per_worker = -(-len(tiles) // len(ths))
    flops_per_mac = 2.0 * tile * tile * tile
    ops = 0
    for w, th in enumerate(ths):
        for (i, j) in tiles[w * per_worker:(w + 1) * per_worker]:
            # One region per output tile: the k-loop's working set is the
            # region's scope, and the speculative fetch of the whole A-row
            # / B-column set is an entry hint (already-cached tiles from
            # row/column reuse are skipped by the backend).
            hint = ([a_h[(i, k)] for k in range(nt)]
                    + [b_h[(k, j)] for k in range(nt)]) if prefetch else ()
            with cl.region(th, prefetch=hint):
                acc = torch.zeros((tile, tile), dtype=torch.float32,
                                  device=dev)
                for k in range(nt):
                    with a_h[(i, k)].read(th) as at, \
                            b_h[(k, j)].read(th) as bt:
                        acc += at @ bt
                    cl.sim.compute(th, flops_per_mac / FLOPS_PER_CYCLE)
                    ops += 1
                c_handle = cl.backend.alloc(th, tile_bytes, acc)
                with c_handle.write(th) as wr:
                    wr.set(acc)
            out[i*tile:(i+1)*tile, j*tile:(j+1)*tile] = acc

    if check:
        torch.testing.assert_close(out, A @ B, rtol=2e-3, atol=5e-2)

    return AppResult("gemm", backend, n_servers, ops, cl.makespan_us(),
                     net=cl.sim.snapshot()["net"],
                     extra={"flops": flops_per_mac * ops,
                            "prefetch": prefetch})


def plain_gemm_us(n: int = 1024, tile: int = 128,
                  workers_per_server: int = 4) -> float:
    """Single-machine original: same blocked schedule and thread count as the
    single-server DSM run, but no protocol instrumentation."""
    nt = n // tile
    cycles = 2.0 * n * n * n / FLOPS_PER_CYCLE
    accesses = nt * nt * nt * 2 + nt * nt * 2       # tile reads + C alloc/write
    return (cycles / 2.6e3 + accesses * 0.14) / workers_per_server
