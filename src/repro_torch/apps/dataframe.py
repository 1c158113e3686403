"""DataFrame (§7.1): columnar analytics with a shared index table.

Mirrors the paper's Polars-based workload: tables are columns partitioned
by row into chunks (heap objects).  Every operation builds a shared *index
table* mapping destination chunks to source chunks — index-builder threads
WRITE entries concurrently (each builder owns its entry shard: SWMR), then
worker threads probe SEVERAL entries (hash-table probing) and process the
source chunks (low compute intensity: the coherence overhead stands out,
Fig. 5a).  Dependent operations re-read chunks (cacheable reuse).

Affinity annotations (§4.1.3, Fig. 6):
  * ``use_tbox``     — chunks of a column are tied into one affinity group:
                       fetched in a single batched READ, deref check skipped.
  * ``use_spawn_to`` — columnar operators run on the server hosting their
                       input column instead of round-robin placement.

``coalesce`` selects who batches the I/O:

* ``"auto"`` (default, drust + batched plane only) — probes and chunk
  scans are *plain per-object derefs*; the runtime registers them and
  coalesces the fetches at quantum close — here mostly at the borrow
  conflict when the next index-entry WRITE lands on a probed entry (the
  write/read ping-pong closes the quantum), so the app carries zero
  drain/fetch choreography.
* ``"manual"`` — the hand-batched choreography: explicit ``read_many`` batches
  for the probe set and both chunk passes (kept for A/B golden pins).

Each chunk is drawn exactly as ``repro.apps.dataframe`` draws it (numpy,
float64, ``seed``) and lives as a float64 tensor on ``device``; the scan
sums it there.  The simulated run — ops, makespan, ``NetStats`` — is the
reference's on any device; ``result_digest`` agrees to the last bits a
different summation order moves.

``batch_io=False`` keeps the legacy per-object plane with identical final
heap/cache state.  ``qps_per_thread``/``ooo``/``cost`` select the
completion model (multi-QP out-of-order plane vs the legacy in-order
plane; see ``core/net.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import backend_caps
from repro_torch.models.transformer import resolve_device
from .common import (AppResult, hot_layout_server, make_cluster,
                     placement_cluster_kw, run_skewed_phases, spread_threads)

CYCLES_PER_BYTE = 110.13
SIMD_LANES = 8                    # AVX2 over f64 rows


def run_dataframe(n_servers: int, backend: str = "drust",
                  n_columns: int = 8, chunks_per_column: int = 32,
                  chunk_rows: int = 512, n_ops: int = 8,
                  probes: int = 4, workers_per_server: int = 4,
                  cores: int = 16, use_tbox: bool = False,
                  use_spawn_to: bool = False, batch_io: bool = True,
                  coalesce: str = "auto", qps_per_thread: int = 1,
                  ooo: bool = False, cost=None, seed: int = 0,
                  placement: str = "static",
                  skew: float | None = None, device="cuda") -> AppResult:
    dev = resolve_device(device)
    caps = backend_caps(backend)
    use_tbox = use_tbox and caps.supports_affinity
    use_spawn_to = use_spawn_to and caps.supports_affinity
    auto = coalesce == "auto" and caps.supports_coalescing and batch_io
    cl = make_cluster(n_servers, backend, cores, batch_io=batch_io,
                      qps_per_thread=qps_per_thread, ooo=ooo, cost=cost,
                      coalesce="auto" if auto else "manual",
                      **placement_cluster_kw(placement))
    rng = np.random.default_rng(seed)
    chunk_bytes = chunk_rows * 8
    chunk_cycles = CYCLES_PER_BYTE * chunk_bytes / SIMD_LANES

    boot = cl.main_thread(0)

    if skew is not None:
        # Zipf-skewed hot-partition mix (the placement_sweep workload):
        # each hot item is a small index entry with a TBox-tied chunk
        # behind it, so a migration moves the whole affinity group as one
        # closure — see ``common.run_skewed_phases``.
        # Fixed-size hot partition set: skew concentrates on the same few
        # groups regardless of cluster size.
        hot_groups = 8
        hot = []
        for j in range(hot_groups):
            root = cl.backend.alloc(boot, 64, (j, 0),
                                    server=hot_layout_server(
                                        placement, j, n_servers))
            if caps.supports_affinity:
                cl.backend.alloc(boot, chunk_bytes, None, tie_to=root)
            hot.append(root)
        boot.t_us = 0.0
        for s in cl.sim.servers:
            s.cpu_busy_us = 0.0
        ths = spread_threads(cl, workers_per_server)
        digest, ops = run_skewed_phases(
            cl, ths, hot, alpha=skew, seed=seed,
            accesses_per_phase=max(1, n_ops * chunks_per_column // 6))
        span = cl.makespan_us()
        return AppResult("dataframe", backend, n_servers, ops, span,
                         net=cl.sim.snapshot()["net"],
                         extra={"placement": placement, "skew": skew,
                                "result_digest": digest})
    columns = []                    # column -> list of chunk handles
    for c in range(n_columns):
        prev = None
        handles = []
        for k in range(chunks_per_column):
            data = torch.from_numpy(rng.standard_normal(chunk_rows)).to(dev)
            if use_tbox and prev is not None:
                # Listing 3: chunks chained with TBox — one affinity group,
                # co-located with the head, fetched in a single batched READ.
                h = cl.backend.alloc(boot, chunk_bytes, data, tie_to=prev)
            else:
                srv = (c if use_tbox else c * chunks_per_column + k) % n_servers
                h = cl.backend.alloc(boot, chunk_bytes, data, server=srv)
            prev = h
            handles.append(h)
        columns.append(handles)

    # Shared index table: one entry object per destination chunk.
    index = [cl.backend.alloc(boot, 64, None, server=k % n_servers)
             for k in range(chunks_per_column)]
    boot.t_us = 0.0
    for s in cl.sim.servers:
        s.cpu_busy_us = 0.0

    ths = spread_threads(cl, workers_per_server)
    choreograph = batch_io and not auto            # manual read_many batches
    digest = 0.0                                   # result bytes (A/B pin)
    ops = 0
    w = 0
    # n_ops independent single-column queries run concurrently (h2oai-style);
    # iteration is k-major so at every step the in-flight items span all
    # columns.  Index builders and workers interleave on the shared table: a
    # fresh entry is written, then probed by workers on other servers — the
    # write/read ping-pong that hammers invalidation-based protocols.
    for k in range(chunks_per_column):
        for op in range(n_ops):
            col = columns[op % n_columns]
            entry = index[k]
            # builder and worker pools rotate independently (co-prime offsets)
            th = ths[w % len(ths)]
            srcs = [(k + d) % chunks_per_column for d in range(2)]
            with entry.write(th) as slot:             # builder owns its shard
                slot.set(srcs)
            ops += 1
            if use_spawn_to:
                # current owner location (tracks transfers/write-moves),
                # not the allocation-time home
                data_srv = cl.backend.locate(col[k])
                cand = [t for t in ths if t.server == data_srv]
                th = min(cand, key=lambda t: t.t_us) if cand \
                    else ths[(w + len(ths) // 2) % len(ths)]
            else:
                th = ths[(w + len(ths) // 2) % len(ths)]
            w += 1
            probe_handles = [index[(k - p) % len(index)]
                             for p in range(1, probes)] + [index[k]]
            if choreograph:                               # batched probing
                srcs = cl.backend.read_many(th, probe_handles)[-1]
            else:
                # plain hash-table probing: per-entry scoped derefs
                # (registered and coalesced by the runtime under
                # coalesce="auto")
                for h in probe_handles[:-1]:
                    with h.read(th):
                        pass
                # Copy while the guard is open: `srcs` outlives this block
                # (scan/materialize passes below), and the payload itself is
                # only valid under the guard.
                with index[k].read(th) as v:
                    srcs = list(v)
            if use_tbox:
                # iterating the column dereferences the head TBox chain:
                # the whole group lands in the local cache in one READ
                with col[0].read(th):
                    pass
            acc = 0.0
            if choreograph:
                scan = cl.backend.read_many(th, [col[s] for s in srcs])
                for chunk in scan:                        # scan pass
                    acc += float(chunk.sum())
                    cl.sim.compute(th, chunk_cycles)
                cl.backend.read_many(th, [col[s] for s in srcs])
                for _ in srcs:                            # materialize pass
                    cl.sim.compute(th, chunk_cycles * 0.25)
            else:
                for s_idx in srcs:
                    with col[s_idx].read(th) as chunk:    # scan pass
                        acc += float(chunk.sum())
                        cl.sim.compute(th, chunk_cycles)
                    with col[s_idx].read(th):             # materialize
                        cl.sim.compute(th, chunk_cycles * 0.25)
            digest += acc
            out = cl.backend.alloc(th, chunk_bytes, acc)
            with out.write(th) as slot:
                slot.set(acc)
            ops += 1

    span = cl.makespan_us()                        # settles pending quanta
    return AppResult("dataframe", backend, n_servers, ops, span,
                     net=cl.sim.snapshot()["net"],
                     extra={"use_tbox": use_tbox, "use_spawn_to": use_spawn_to,
                            "batch_io": batch_io,
                            "coalesce": "auto" if auto else "manual",
                            "result_digest": digest})


def plain_dataframe_us(n_columns: int = 8, chunks_per_column: int = 32,
                       chunk_rows: int = 512, n_ops: int = 8,
                       probes: int = 4, workers_per_server: int = 4) -> float:
    chunk_bytes = chunk_rows * 8
    chunk_cycles = CYCLES_PER_BYTE * chunk_bytes / SIMD_LANES
    compute = n_ops * chunks_per_column * 2 * chunk_cycles * 1.25
    accesses = n_ops * chunks_per_column * (1 + probes + 1 + 4 + 2)
    return (compute / 2.6e3 + accesses * 0.14) / workers_per_server
