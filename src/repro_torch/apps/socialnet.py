"""SocialNet (§7.1): a microservice pipeline passing references, not values.

DeathStarBench's social network decomposed into services (compose → text →
media → storage) connected by channels.  The original deployment serializes
every payload into RPC byte streams; on DSM the services pass 16-byte heap
references and the receiving service fetches the object on dereference.
DRust's win (Fig. 5b): no serialize/deserialize compute, no redundant
copies, one one-sided READ per actual use.

``by_value=True`` reproduces the original (non-DSM) distributed baseline.

``coalesce`` selects who batches the I/O:

* ``"auto"`` (default, drust + batched plane only) — the services run the
  *plain* per-request send/recv/deref loop with zero drain/fetch
  choreography; the runtime stages the reference sends per (sender,
  destination) pair and registers the derefs, coalescing both into wire
  messages / ``read_many`` doorbells at quantum close (see
  ``core/runtime.py``'s ``DerefCoalescer``).
* ``"manual"`` — the hand-batched choreography: every service drains
  its inbox per request class and fetches the batch through one explicit
  ``read_many`` (kept for A/B; this is what the golden fixtures pin).

``batch_io=False`` keeps the legacy per-object plane — protocol state ends
up identical in every mode, only the verb accounting coalesces.
``qps_per_thread``/``ooo``/``cost`` select the completion model (multi-QP
out-of-order plane vs the legacy in-order plane; see ``core/net.py``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import Channel, backend_caps
from .common import (AppResult, hot_layout_server, make_cluster,
                     placement_cluster_kw, run_skewed_phases, spread_threads)

TEXT_BYTES = 1024
MEDIA_BYTES = 50 * 1024
SER_CYCLES_PER_BYTE = 1.5          # serialize + deserialize, each way
POST_PROC_CYCLES = 60_000          # per-service request handling
STORE_PROC_CYCLES = 30_000         # storage-service write path
RPC_STACK_CYCLES = 40_000          # Thrift/HTTP stack per side, cross-server


def drain_order(class_map: dict) -> list:
    """Deterministic inbox-drain order for the manual batched plane: the
    per-class map is keyed ``(k, src_server)`` and drained in sorted key
    order, whatever order the classes were built in — golden counters must
    depend on the workload, not on dict-insertion iteration."""
    return sorted(class_map)


def run_socialnet(n_servers: int, backend: str = "drust",
                  n_requests: int = 400, media_frac: float = 0.25,
                  workers_per_server: int = 4, cores: int = 16,
                  by_value: bool = False, batch_io: bool = True,
                  coalesce: str = "auto", qps_per_thread: int = 1,
                  ooo: bool = False, cost=None, seed: int = 0,
                  placement: str = "static",
                  skew: float | None = None) -> AppResult:
    # The runtime deref coalescer needs ownership borrows + the batched
    # plane; every other configuration runs the manual choreography.
    auto = (coalesce == "auto" and backend_caps(backend).supports_coalescing
            and batch_io and not by_value)
    cl = make_cluster(n_servers, backend, cores, batch_io=batch_io,
                      qps_per_thread=qps_per_thread, ooo=ooo, cost=cost,
                      coalesce="auto" if auto else "manual",
                      **placement_cluster_kw(placement))
    rng = np.random.default_rng(seed)
    boot = cl.main_thread(0)

    if skew is not None:
        # Zipf-skewed hot-profile mix (the placement_sweep workload): a
        # small set of hot user profiles updated by movable compose
        # workers and read mostly by one phase-dominant timeline service
        # per phase — see ``common.run_skewed_phases``.
        # A fixed-size hot set: the skew is the workload's point — a
        # bigger cluster does not mint more celebrities, it just puts
        # more distance between them and their readers.
        hot_profiles = 8
        hot = [cl.backend.alloc(boot, TEXT_BYTES, (j, 0),
                                server=hot_layout_server(
                                    placement, j, n_servers))
               for j in range(hot_profiles)]
        boot.t_us = 0.0
        ths = spread_threads(cl, workers_per_server)
        digest, ops = run_skewed_phases(
            cl, ths, hot, alpha=skew, seed=seed,
            accesses_per_phase=max(1, n_requests // 6))
        span = cl.makespan_us()
        return AppResult("socialnet", backend, n_servers, ops, span,
                         net=cl.sim.snapshot()["net"],
                         extra={"placement": placement, "skew": skew,
                                "payload_digest": digest})

    ths = spread_threads(cl, workers_per_server)
    n_stages = 4                                   # compose→text→media→storage
    # Stages 0-2 scale out over every server (stateless replicas, spread like
    # Docker Swarm); the post-storage service is stateful and stays sharded on
    # server 0 — the dependency that limits SocialNet's scaling in Fig. 5b.
    stride = max(1, len(ths) // n_stages)
    storage_pool = [t for t in ths if t.server == 0]
    stage_workers = [[ths[(k + s * stride) % len(ths)] for k in range(len(ths))]
                     for s in range(n_stages - 1)]
    stage_workers.append([storage_pool[k % len(storage_pool)]
                          for k in range(len(ths))])
    chans = [Channel(cl) for _ in range(n_stages - 1)]
    has_media = rng.random(n_requests) < media_frac
    nbytes_of = [TEXT_BYTES + (MEDIA_BYTES if has_media[i] else 0)
                 for i in range(n_requests)]

    # Stage-phased (batched) execution: every service drains its inbox, then
    # hands the batch downstream — a steady-state throughput pipeline.  Sends
    # and receives are separate sub-phases so independent requests overlap
    # (the FIFO happens-before only orders each message, not the batch).
    inflight: list = [None] * n_requests
    digest = 0                                     # fetched payload bytes
    for i in range(n_requests):                    # stage 0: compose
        th0 = stage_workers[0][i % len(ths)]
        cl.sim.compute(th0, POST_PROC_CYCLES)
        inflight[i] = cl.backend.alloc(th0, nbytes_of[i],
                                       bytes(min(nbytes_of[i], 4096)))
    batched = batch_io and not by_value and not auto
    for s in range(1, n_stages):
        chan = chans[s - 1]
        if batched:
            # Manual choreography: requests in the same class k = i %
            # len(ths) share their (src, dst) worker pair in every stage —
            # one wire message and one batched fetch per class, drained in
            # the deterministic (k, src server) order.
            class_map: dict = {}
            for k in range(len(ths)):
                idxs = [i for i in range(n_requests) if i % len(ths) == k]
                if idxs:
                    class_map[(k, stage_workers[s - 1][k].server)] = idxs
            for key in drain_order(class_map):     # send sub-phase: one wire
                k, _src = key                      # message per worker pair
                idxs = class_map[key]
                src = stage_workers[s - 1][k]
                dst = stage_workers[s][k]
                chan.recv_server = dst.server
                chan.send_many(src, [inflight[i] for i in idxs])
            for key in drain_order(class_map):     # recv sub-phase: drain the
                k, _src = key                      # inbox, then batched fetch
                idxs = class_map[key]
                dst = stage_workers[s][k]
                handles = []
                for i in idxs:
                    handle = chan.recv(dst)
                    proc = (STORE_PROC_CYCLES if s == n_stages - 1
                            else POST_PROC_CYCLES)
                    cl.sim.compute(dst, proc)
                    handles.append(handle)
                    inflight[i] = handle
                for data in cl.backend.read_many(dst, handles):
                    digest += len(data)
            continue
        for i in range(n_requests):                # send sub-phase
            src = stage_workers[s - 1][i % len(ths)]
            dst = stage_workers[s][i % len(ths)]
            chan.recv_server = dst.server
            if by_value:
                cl.sim.compute(src, SER_CYCLES_PER_BYTE * nbytes_of[i])
                if src.server != dst.server:
                    cl.sim.compute(src, RPC_STACK_CYCLES)
                chan.send(src, inflight[i], nbytes=nbytes_of[i])
            else:
                chan.send(src, inflight[i])        # 16-byte reference
        for i in range(n_requests):                # recv sub-phase
            src = stage_workers[s - 1][i % len(ths)]
            dst = stage_workers[s][i % len(ths)]
            handle = chan.recv(dst)
            if by_value:
                cl.sim.compute(dst, SER_CYCLES_PER_BYTE * nbytes_of[i])
                if src.server != dst.server:
                    cl.sim.compute(dst, RPC_STACK_CYCLES)
            proc = STORE_PROC_CYCLES if s == n_stages - 1 else POST_PROC_CYCLES
            cl.sim.compute(dst, proc)
            if not by_value:
                with handle.read(dst) as data:        # fetch on dereference
                    digest += len(data)               # (scoped borrow)
            inflight[i] = handle

    span = cl.makespan_us()                        # settles pending quanta
    return AppResult("socialnet", backend if not by_value else "original",
                     n_servers, n_requests, span,
                     net=cl.sim.snapshot()["net"],
                     extra={"batch_io": batch_io and not by_value,
                            "coalesce": "auto" if auto else "manual",
                            "payload_digest": digest})


def plain_socialnet_us(n_requests: int = 400, media_frac: float = 0.25,
                       workers_per_server: int = 4) -> float:
    """Original single-node deployment: the Docker-composed RPC version —
    services still serialize every payload into byte streams even on one
    machine (loopback transport, so no cross-host RPC stack cost).  This is
    the paper's Fig. 5b normalizer, which is why even the single-node DSM
    versions beat it ~2x."""
    avg_bytes = TEXT_BYTES + MEDIA_BYTES * media_frac
    per_req = ((3 * POST_PROC_CYCLES + STORE_PROC_CYCLES) / 2.6e3
               + 3 * 2 * SER_CYCLES_PER_BYTE * avg_bytes / 2.6e3  # ser+deser
               + 3 * (0.14 + avg_bytes / 2e4)  # loopback RPC hand-offs
               + 0.14)                         # alloc
    return n_requests * per_req / workers_per_server
