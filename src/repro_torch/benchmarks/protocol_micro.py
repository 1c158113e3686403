"""Protocol micro-benchmarks: network messages per operation type (the
counterpart of ``benchmarks/protocol_micro.py``, on ``repro_torch``).

The paper's core claim in microcosm: DRust needs ZERO control messages for
cached reads and exactly one one-sided READ for cold ones; directory
protocols pay multi-hop lookups and invalidation rounds; delegation pays a
round trip for everything.

The batched I/O plane sweeps measure what doorbell coalescing buys:
round-trips and makespan for TBox group fetches (group size sweep), batched
remote reads (server count sweep), and pipelined write-backs (depth sweep),
each against the equivalent unbatched op sequence with identical final
heap/cache state.

The multi-QP sweeps (``qp_writeback_sweep``/``qp_readmany_sweep``) measure
the out-of-order completion plane: makespan vs QP count at 8 servers, with
round trips held constant — the NIC's per-QP message rate is the serial
bottleneck that striping doorbells across QPs removes.

The coalesce-budget sweep (``coalesce_budget_sweep``) drives the runtime
deref coalescer (``Cluster(coalesce="auto")``) across static quantum
budgets and three request mixes (small / bulk / mixed object sizes) on the
multi-QP plane, and pins that the *adaptive* policy tracks the best static
batch size per mix — large quanta when the per-QP message rate dominates,
knee-bounded quanta when bandwidth does.

The recovery sweep (``recovery_sweep``/``recovery_summary``) crashes one
server under the OOO plane (with a dirty unflushed write and an in-flight
speculative READ to quiesce) at 2/4/8/16 servers x two working-set sizes,
and gates the paper-shaped SLO: the fail-over makespan scales with the
dead server's restored working set, not with cluster size.

The serving sweep (``_serve_run``/``serve_summary``) replays seeded
open-loop arrival traces (Poisson and bursty) against a ``ServeFleet``
of DSM-backed engine replicas at 1/4/8 servers and reports the tail
latency (p50/p99, queueing included) and SLO-met goodput that
``check_regression.py`` gates — serving SLOs, not just protocol counters.

The lock-contention sweep (``_lock_run``/``lock_sweep_summary``) hammers
16 distributed locks under zipf(0.99) skew at 2/8/64 servers in three
synchronization designs (``docs/sync.md``): spin DMutex (remote verbs
per data access while holding the lock), delegation/combining DMutex
(critical sections ship to the lock home; one amortized round trip per
convoy), and DRwLock reader leases (reads free after the grant until a
writer revokes).  Delegation must beat spin on makespan AND round trips
at 8+ servers with the gap widening in cluster size — the scalable-
synchronization acceptance criterion, pinned by the gate.

Everything here runs on virtual clocks except ``clone_fastpath_guard``'s
times and ``sanitize_overhead_summary``'s wall-clock columns.  ``device``
places the tensors of the runs that hold any (GEMM's tiles, DataFrame's
chunks, the serving sweep's weights); the simulated trajectory does not
depend on it.
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import torch

from repro_torch.analysis.sanitizer import Sanitizer
from repro_torch.apps.common import zipf_keys
from repro_torch.apps.dataframe import run_dataframe
from repro_torch.apps.kvstore import run_kvstore
from repro_torch.apps.socialnet import run_socialnet
from repro_torch.core import (Cluster, CoalescePolicy, DMutex, DRwLock,
                              OwnedState)
from repro_torch.core.ownership import _clone
from repro_torch.models.transformer import resolve_device
from repro_torch.serve import (OpenLoopDriver, ServeFleet, bursty_trace,
                               poisson_trace, synth_prompts)


def _fresh(backend: str):
    cl = Cluster(4, backend=backend)
    t0 = cl.main_thread(0)
    t1 = cl.main_thread(0); t1.server = 1
    t2 = cl.main_thread(0); t2.server = 2
    box = cl.backend.alloc(t0, 512, b"x" * 512)
    return cl, (t0, t1, t2), box


def _msgs(cl) -> int:
    """Critical-path (synchronous) messages; DRust's invalidation/dealloc
    traffic and pipelined write-backs are asynchronous by design and
    reported separately."""
    return cl.sim.net.critical_path_msgs()


def rows_for(backend: str):
    out = []
    # cold remote read
    cl, (t0, t1, t2), box = _fresh(backend)
    m0 = _msgs(cl)
    cl.backend.read(t1, box)
    out.append((f"proto_{backend}_cold_read_msgs", 0.0, _msgs(cl) - m0))
    # warm (cached) read
    m0 = _msgs(cl)
    cl.backend.read(t1, box)
    out.append((f"proto_{backend}_warm_read_msgs", 0.0, _msgs(cl) - m0))
    # remote write after 2 readers cached it (invalidation pressure)
    cl.backend.read(t2, box)
    m0 = _msgs(cl)
    cl.backend.write(t2, box, b"y" * 512)
    out.append((f"proto_{backend}_write_2sharers_msgs", 0.0, _msgs(cl) - m0))
    # read-after-write from the other server (stale-copy handling)
    m0 = _msgs(cl)
    cl.backend.read(t1, box)
    out.append((f"proto_{backend}_read_after_write_msgs", 0.0,
                _msgs(cl) - m0))
    return out


# --------------------------------------------------------------------------
#  Batched I/O plane sweeps
# --------------------------------------------------------------------------
def group_fetch_sweep(group_sizes=(1, 4, 16, 64)):
    """TBox affinity group of N chunks fetched through the head: the batched
    plane issues ONE coalesced READ (1 doorbell, N verbs); the naive plane
    expands the same group into N independent READ verbs."""
    rows = []
    for n in group_sizes:
        for batch_io in (True, False):
            cl = Cluster(2, batch_io=batch_io)
            t0 = cl.main_thread(0)
            t1 = cl.main_thread(0); t1.server = 1
            prev, head = None, None
            for _ in range(n):
                prev = cl.backend.alloc(t0, 256, b"c" * 256, tie_to=prev)
                head = head or prev
            rt0, t_us0 = cl.sim.net.round_trips, t1.t_us
            cl.backend.read(t1, head)
            mode = "batched" if batch_io else "unbatched"
            rows.append((f"group{n}_fetch_{mode}_rtt", t1.t_us - t_us0,
                         cl.sim.net.round_trips - rt0))
    return rows


def read_many_sweep(n_objects=32, server_counts=(1, 2, 4, 8)):
    """Doorbell-batched reads of objects spread over K source servers:
    round trips collapse to K (one doorbell per server)."""
    rows = []
    for backend in ("drust", "gam", "grappa"):
        for k in server_counts:
            cl = Cluster(k + 1, backend=backend)
            t0 = cl.main_thread(k)           # reader lives on the last server
            boxes = [cl.backend.alloc(t0, 256, b"x" * 256, server=i % k)
                     for i in range(n_objects)]
            rt0, t_us0 = cl.sim.net.round_trips, t0.t_us
            cl.backend.read_many(t0, boxes)
            rows.append((f"readmany_{backend}_{k}srv_rtt", t0.t_us - t_us0,
                         cl.sim.net.round_trips - rt0))
    return rows


def writeback_depth_sweep(depths=(1, 8, 64)):
    """Pipelined DropMutRef write-backs: N remote writes post N async 8-byte
    WRITEs; the critical path pays only the issue cost, round trips stay 0
    until the fence (compare the seed's 1 sync round trip per write)."""
    rows = []
    for d in depths:
        for batch_io in (True, False):
            cl = Cluster(2, batch_io=batch_io)
            t0 = cl.main_thread(0)
            t1 = cl.main_thread(0); t1.server = 1
            boxes = [cl.backend.alloc(t1, 64, i, server=1) for i in range(d)]
            for b in boxes:                  # move every object to server 0
                cl.backend.write(t0, b, 0)   # once: owner home stays t1
            rt0, t_us0 = cl.sim.net.round_trips, t0.t_us
            wb0 = cl.sim.net.async_writebacks
            for i, b in enumerate(boxes):
                cl.backend.write(t0, b, i)   # local write + 8B write-back
            mode = "batched" if batch_io else "unbatched"
            rows.append((f"wb_depth{d}_{mode}_critpath_rtt",
                         t0.t_us - t_us0, cl.sim.net.round_trips - rt0))
            if batch_io:
                rows.append((f"wb_depth{d}_async_posted", cl.makespan_us(),
                             cl.sim.net.async_writebacks - wb0))
    return rows


def _qp_wb_run(qps: int, depth: int, n_servers: int = 8,
               mixed_sizes: bool = False):
    """One multi-QP write-back trace: a writer on server 0 retires mutable
    borrows of ``depth`` objects owned across the other servers; each drop
    posts an async 8 B owner write-back.  ``mixed_sizes`` first posts a
    burst of 16 KiB stack write-backs (D.1) — those backlog the QPs they
    land on, so the small verbs striped onto sibling QPs complete out of
    order.  Ends with an ownership transfer so the completion-id fence path
    runs.  Returns (cluster, writer)."""
    cl = Cluster(n_servers, backend="drust", ooo=True, qps_per_thread=qps)
    t0 = cl.main_thread(0)
    owners = []
    for s in range(1, n_servers):
        th = cl.main_thread(0)
        th.server = s
        owners.append(th)
    boxes = []
    for i in range(depth):
        th = owners[i % len(owners)]
        b = cl.backend.alloc(th, 64, i)          # owner slot lives remotely
        cl.backend.write(t0, b, 0)               # move payload to the writer
        boxes.append(b)
    cl.sim.reset()                               # measure only the wb phase
    for th in owners + [t0]:
        th.t_us = 0.0
    if mixed_sizes:                              # D.1 stack write-back burst
        for j in range(3):
            cl.sim.wb.post(t0, 1 + j % (n_servers - 1), 16384)
    for i, b in enumerate(boxes):
        cl.backend.write(t0, b, i)               # local write + async 8B wb
    cl.drust.transfer(t0, boxes[0], 1)           # fence only boxes[0]'s cids
    return cl, t0


def qp_writeback_sweep(qp_counts=(1, 2, 4), depths=(8, 56), n_servers=8):
    """Multi-QP out-of-order completion plane: with one QP the NIC's per-QP
    message rate serializes the write-back completion tail; striping the
    doorbells across QPs overlaps it.  Round trips stay constant (only the
    trailing transfer is synchronous) — the makespan is what moves."""
    rows = []
    for d in depths:
        for q in qp_counts:
            cl, t0 = _qp_wb_run(q, d, n_servers)
            net = cl.sim.net
            rows.append((f"qp{q}_wbdepth{d}_makespan", cl.makespan_us(),
                         net.round_trips))
            rows.append((f"qp{q}_wbdepth{d}_ooo", 0.0, net.ooo_completions))
            rows.append((f"qp{q}_wbdepth{d}_fenced", 0.0, net.fenced_verbs))
    return rows


def qp_readmany_sweep(qp_counts=(1, 2, 4, 8), n_objects=56, n_servers=8):
    """Sync doorbell path under the out-of-order plane: one batched read of
    ``n_objects`` spread over the other servers.  One QP serializes the
    per-doorbell WQE processing; multiple QPs overlap the doorbells again
    (round trips: one per source server, identical at every QP count)."""
    rows = []
    for q in qp_counts:
        cl = Cluster(n_servers, backend="drust", ooo=True, qps_per_thread=q)
        t0 = cl.main_thread(n_servers - 1)
        boxes = [cl.backend.alloc(t0, 256, b"x" * 256,
                                  server=i % (n_servers - 1))
                 for i in range(n_objects)]
        cl.sim.reset()
        t0.t_us = 0.0
        cl.backend.read_many(t0, boxes)
        rows.append((f"qp{q}_readmany_makespan", cl.makespan_us(),
                     cl.sim.net.round_trips))
    return rows


def qp_sweep_summary(qp_counts=(1, 2, 4), depths=(8, 56)) -> dict:
    """Deterministic multi-QP trajectory for ``BENCH_protocol.json`` — every
    value here comes from the virtual clock / message counters, so the
    regression gate can pin them exactly."""
    out = {}
    for d in depths:
        for q in qp_counts:
            cl, _ = _qp_wb_run(q, d, mixed_sizes=True)
            net = cl.sim.net
            out[f"qps{q}_depth{d}"] = {
                "makespan_us": round(cl.makespan_us(), 3),
                "round_trips": net.round_trips,
                "ooo_completions": net.ooo_completions,
                "fences": net.fences,
                "fenced_verbs": net.fenced_verbs,
                "qp_switches": net.qp_switches,
            }
    return out


COALESCE_MIXES = ("small", "bulk", "mixed")
COALESCE_BUDGETS = (1, 4, 16, 64)
EXPOSE_SLO_US = 2.0        # latency-exposure SLO column: flush at 2us pending
EXPOSE_THINK_CYCLES = 1300  # ~0.5us of per-request work between derefs


def _coalesce_run(mix: str, budget, n_objects: int = 96, n_servers: int = 8,
                  qps: int = 4, think_cycles: int = 0):
    """One coalescer trace: a reader on the last server issues plain
    per-object derefs of ``n_objects`` spread over the other servers; the
    runtime registers and flushes them under the given quantum budget
    (``"auto"`` = the adaptive policy, ``"expose"`` = adaptive + the
    ``max_expose_us`` latency-SLO cap).  ``think_cycles`` inserts compute
    between derefs — the exposure SLO only has something to bound when
    virtual time passes inside the quantum.  Returns (cluster, reader)."""
    policy = (CoalescePolicy() if budget == "auto"
              else CoalescePolicy(max_expose_us=EXPOSE_SLO_US)
              if budget == "expose"
              else CoalescePolicy(max_pending=budget))
    cl = Cluster(n_servers, backend="drust", ooo=True, qps_per_thread=qps,
                 coalesce="auto", coalesce_policy=policy)
    t0 = cl.main_thread(n_servers - 1)
    sizes = {
        "small": [256] * n_objects,
        "bulk": [16384] * n_objects,
        "mixed": [256 if i % 2 else 16384 for i in range(n_objects)],
    }[mix]
    boxes = [cl.backend.alloc(t0, sz, bytes(min(sz, 64)),
                              server=i % (n_servers - 1))
             for i, sz in enumerate(sizes)]
    cl.sim.reset()                               # measure only the deref phase
    t0.t_us = 0.0
    for b in boxes:
        cl.backend.read(t0, b)
        if think_cycles:
            cl.sim.compute(t0, think_cycles)
    return cl, t0


def coalesce_budget_sweep():
    """Makespan vs static quantum budget per request mix, plus the adaptive
    policy and the adaptive+latency-SLO column (``expose``: the coalescer
    force-flushes once the oldest registered deref has been pending longer
    than ``EXPOSE_SLO_US``): the ``derived`` column is the round-trip count
    (doorbells), the headline is that ``auto`` lands at the best static
    budget's makespan on every mix — big quanta for small objects,
    knee-bounded for bulk — while ``expose`` trades some of that makespan
    for a bounded deref-latency exposure."""
    rows = []
    for mix in COALESCE_MIXES:
        for budget in COALESCE_BUDGETS + ("auto", "expose"):
            think = EXPOSE_THINK_CYCLES if budget == "expose" else 0
            cl, _ = _coalesce_run(mix, budget, think_cycles=think)
            rows.append((f"coalesce_{mix}_budget{budget}",
                         cl.makespan_us(), cl.sim.net.round_trips))
    return rows


def coalesce_summary() -> dict:
    """Deterministic coalesce-sweep trajectory for ``BENCH_protocol.json``:
    per mix, the adaptive policy's makespan/round-trips/flushes and its
    ratio to the best static budget — the regression gate holds the ratio's
    makespan within tolerance and pins the counters exactly."""
    out = {}
    for mix in COALESCE_MIXES:
        best = None
        for budget in COALESCE_BUDGETS:
            cl, _ = _coalesce_run(mix, budget)
            span = cl.makespan_us()
            best = span if best is None else min(best, span)
        cl, _ = _coalesce_run(mix, "auto")
        span = cl.makespan_us()
        co = cl.drust.coalescer
        out[mix] = {
            "makespan_us": round(span, 3),
            "best_static_us": round(best, 3),
            "auto_over_best": round(span / best, 4),
            "round_trips": cl.sim.net.round_trips,
            "flushes": co.flushes,
            "coalesced_derefs": co.flushed_derefs,
        }
    return out


# --------------------------------------------------------------------------
#  Crash-recovery sweep (fail-over SLO)
# --------------------------------------------------------------------------
def _recovery_run(n_servers: int, n_boxes: int, size: int = 4096):
    """One fail-over trace: server 1 owns ``n_boxes`` objects of ``size``
    bytes (flushed), plus one dirty unflushed write and one in-flight
    speculative READ out of it — so the quiesce, the epoch revert, AND the
    promote-restore paths all run.  Returns (cluster, RecoveryReport)."""
    cl = Cluster(n_servers, backend="drust", replicate=True,
                 qps_per_thread=2, ooo=True)
    t0 = cl.main_thread(0)
    tv = cl.main_thread(0); tv.server = 1
    boxes = [cl.backend.alloc(tv, size, i, server=1) for i in range(n_boxes)]
    cl.replicator.flush_epoch()
    cl.backend.write(tv, boxes[0], -1)           # dirty at crash time
    cl.drust.prefetch(t0, [boxes[1]])            # orphaned speculative READ
    cl.recovery.crash(1)
    rep = cl.recovery.fail_over(1, t0)
    return cl, rep


def recovery_sweep(server_counts=(2, 4, 8, 16), box_counts=(8, 64)):
    """Fail-over makespan vs (cluster size, lost working set): the derived
    column is the restored partition image in bytes — the quantity the
    makespan must track (SLO), while the server-count axis only adds the
    per-survivor restripe handshake."""
    rows = []
    for n in server_counts:
        for nb in box_counts:
            cl, rep = _recovery_run(n, nb)
            rows.append((f"recovery_{n}srv_{nb}boxes_makespan",
                         rep.makespan_us, rep.restored_bytes))
    return rows


def recovery_summary() -> dict:
    """Deterministic recovery trajectory for ``BENCH_protocol.json``: the
    per-point counters are pinned exactly, the makespans within tolerance,
    and the SLO ratio pair — working-set scaling must dominate
    cluster-size scaling — is gated as a boolean."""
    out = {}
    for n in (2, 4, 8, 16):
        for nb in (8, 64):
            cl, rep = _recovery_run(n, nb)
            out[f"srv{n}_boxes{nb}"] = {
                "makespan_us": round(rep.makespan_us, 3),
                "restored_bytes": rep.restored_bytes,
                "rehomed_boxes": rep.rehomed_boxes,
                "orphaned_cids": rep.orphaned_cids,
                "lost_writes": rep.lost_writes,
                "broken_locks": rep.broken_locks,
                "dead_threads": rep.dead_threads,
            }
    return out


def recovery_slo() -> dict:
    """The SLO gate: growing the WORKING SET 8x at fixed cluster must move
    the makespan more than growing the CLUSTER 8x at fixed working set."""
    spans = {}
    for n, nb in ((4, 8), (4, 64), (2, 8), (16, 8)):
        _, rep = _recovery_run(n, nb)
        spans[(n, nb)] = rep.makespan_us
    ws_scale = spans[(4, 64)] / spans[(4, 8)]
    srv_scale = spans[(16, 8)] / spans[(2, 8)]
    return {
        "ws_scale_4srv_8to64_boxes": round(ws_scale, 3),
        "srv_scale_8boxes_2to16_srv": round(srv_scale, 3),
        "slo_ok": bool(ws_scale > srv_scale),
    }


# --------------------------------------------------------------------------
#  Lock-contention sweep (spin vs delegation vs reader leases)
# --------------------------------------------------------------------------
def _lock_run(n_servers: int, mode: str, skew: float = 0.99,
              n_locks: int = 16, ops_per_server: int = 16, reads: int = 2,
              seed: int = 0):
    """One contention run: one worker per server, ``ops_per_server`` ops
    each over ``n_locks`` lock-protected counters (homes striped across
    servers) under zipf(``skew``) lock choice.  ``mode="spin"`` /
    ``"delegate"`` run identical critical sections (bump the counter,
    ``reads`` data accesses on the lock home) through ``DMutex``;
    ``mode="lease"`` runs a 90/10 read/write mix through ``DRwLock``.
    Returns ``(cluster, primitives)`` — final counter values must be
    identical across DMutex modes (the equivalence oracle)."""
    cl = Cluster(n_servers, backend="drust")
    boot = cl.main_thread(0)
    if mode == "lease":
        prims = [DRwLock(cl, boot, value=0, server=i % n_servers)
                 for i in range(n_locks)]
    else:
        prims = [DMutex(cl, boot, value=0, mode=mode, server=i % n_servers)
                 for i in range(n_locks)]
    boot.t_us = 0.0
    for s in cl.sim.servers:
        s.cpu_busy_us = 0.0
    ths = []
    for s in range(n_servers):
        th = cl.main_thread(0)
        th.server = s
        ths.append(th)
    n_ops = n_servers * ops_per_server
    hot = zipf_keys(n_ops, n_locks, alpha=skew, seed=seed)

    def bump(o):
        o.data += 1
        return o.data

    for i in range(n_ops):
        th = ths[i % n_servers]
        lk = prims[int(hot[i])]
        if mode == "lease":
            if i % 10 == 7:                      # 10% writers
                lk.write(th, i)
            else:
                with lk.read(th):
                    pass
        else:
            lk.with_lock(th, bump, reads=reads, read_bytes=256)
    return cl, prims


def lock_sweep_summary(server_counts=(2, 8, 64)) -> dict:
    """Deterministic contention trajectory for ``BENCH_protocol.json``:
    makespan within tolerance, the synchronization counters pinned
    exactly.  The ``spin_over_delegate`` ratio in each delegate row is
    the acceptance criterion made visible (must exceed 1.0 at 8+ servers,
    widening with cluster size); it is derived, not gated."""
    out: dict = {}
    for n in server_counts:
        for mode in ("spin", "delegate", "lease"):
            cl, _prims = _lock_run(n, mode)
            net = cl.sim.net
            row = {
                "makespan_us": round(cl.makespan_us(), 2),
                "round_trips": net.round_trips,
                "atomics": net.atomics,
            }
            if mode == "delegate":
                row.update(
                    delegated_sections=net.delegated_sections,
                    convoy_completions=net.convoy_completions,
                    closure_ships=net.closure_ships,
                    spin_over_delegate=round(
                        out[f"spin_{n}srv"]["makespan_us"]
                        / max(1e-9, cl.makespan_us()), 2))
            elif mode == "lease":
                row.update(lease_grants=net.lease_grants,
                           lease_revokes=net.lease_revokes)
            out[f"{mode}_{n}srv"] = row
    return out


# --------------------------------------------------------------------------
#  Placement sweep (static layouts vs telemetry-driven live migration)
# --------------------------------------------------------------------------
def _placement_run(n_servers: int, mode: str, app: str, device="cuda"):
    """One zipf-skewed phase-rotating run (``apps.common.run_skewed_phases``)
    of a skewed app under one placement mode.  ``spread``/``packed`` are
    static layouts on the byte-identical default plane; ``auto`` installs
    the telemetry tracker (``core/runtime.PlacementTracker``) and lets hot
    objects migrate to their phase-dominant reader.  Returns the
    ``AppResult`` — the payload digest folds every value read in schedule
    order, so all three modes must produce the same digest."""
    if app == "socialnet":
        return run_socialnet(n_servers, "drust", n_requests=1200,
                             placement=mode, skew=0.99)
    return run_dataframe(n_servers, "drust", n_ops=38,
                         placement=mode, skew=0.99, device=device)


PLACEMENT_SIZES = (2, 8, 16, 64)
PLACEMENT_GATED_SIZES = (8, 16, 64)    # auto must strictly win here


def placement_summary(server_counts=PLACEMENT_SIZES, device="cuda") -> dict:
    """Deterministic placement trajectory for ``BENCH_protocol.json``:
    makespan within tolerance, the placement counters (round trips, owner
    migrations, migration round trips, quantum merges) pinned exactly.
    Each ``auto`` row carries the best static layout's makespan/round
    trips and the ``auto_beats_static`` acceptance bool (strict win on
    BOTH at 8+ servers, with identical digests) that the gate must not
    see flip to false."""
    out: dict = {}
    for app in ("socialnet", "dataframe"):
        for n in server_counts:
            static = {}
            for mode in ("spread", "packed", "auto"):
                res = _placement_run(n, mode, app, device)
                net = res.net
                digest = res.extra.get("payload_digest",
                                       res.extra.get("result_digest"))
                row = {
                    "makespan_us": round(res.makespan_us, 2),
                    "round_trips": net["round_trips"],
                    "owner_migrations": net["owner_migrations"],
                    "migration_round_trips": net["migration_round_trips"],
                    "quantum_merges": net["quantum_merges"],
                    "digest": digest,
                }
                if mode == "auto":
                    best_span = min(v["makespan_us"] for v in static.values())
                    best_rts = min(v["round_trips"] for v in static.values())
                    row.update(
                        best_static_makespan_us=best_span,
                        best_static_round_trips=best_rts,
                        auto_beats_static=bool(
                            n not in PLACEMENT_GATED_SIZES
                            or (res.makespan_us < best_span
                                and net["round_trips"] < best_rts
                                and all(v["digest"] == digest
                                        for v in static.values()))))
                else:
                    static[mode] = row
                out[f"{app}_{mode}_{n}srv"] = row
    return out


# --------------------------------------------------------------------------
#  Serving SLO sweep (open-loop tail latency + goodput)
# --------------------------------------------------------------------------
SERVE_SLO_US = 5000.0        # per-request latency SLO (arrival -> last token)
SERVE_DECODE_CYCLES = 390_000.0          # ~150 us/decode tick at 2.6 GHz


def _serve_run(n_servers: int, trace: str = "poisson",
               n_requests: int = 72, rate_per_s: float = 2500.0,
               seed: int = 11, wire: str = "int8",
               weight_push_every: int = 8, device="cuda"):
    """One open-loop serving trace: a ``ServeFleet`` (one engine replica
    per server, shared DSM page table) replayed against a seeded arrival
    trace.  The decode function is a deterministic stub — the trajectory
    measured here is purely the protocol + queueing behavior on virtual
    clocks, so the SLO columns are byte-reproducible.  Weight pushes every
    ``weight_push_every`` steps bump the published color, forcing real
    int8 wire refreshes mid-load.  The weights are a float32 tensor on
    ``device``.  Returns (cluster, fleet, the ``OpenLoopDriver``)."""
    cl = Cluster(n_servers, backend="drust", ooo=True, qps_per_thread=2)
    weights = OwnedState("bench_w", {"w": torch.ones(
        (128, 128), dtype=torch.float32, device=device)})

    def stub_step(params, cache, tokens):
        return (tokens * 13 + 7) % 997, cache

    fleet = ServeFleet(cl, step_fn=stub_step, page_size=8, slots=4,
                       max_len=64, weights=weights, wire=wire,
                       weights_server=0,
                       decode_cycles=SERVE_DECODE_CYCLES)
    prompts = synth_prompts(n_requests, seed=seed)
    mk = poisson_trace if trace == "poisson" else bursty_trace
    arrivals = mk(rate_per_s, n_requests, seed=seed + 1)
    drv = OpenLoopDriver(fleet, arrivals, prompts, max_new=8,
                         weight_push_every=weight_push_every)
    drv.run()
    return cl, fleet, drv


SERVE_POINTS = (("poisson_1srv", 1, "poisson"),
                ("poisson_4srv", 4, "poisson"),
                ("poisson_8srv", 8, "poisson"),
                ("bursty_4srv", 4, "bursty"))


def serve_slo_sweep(device="cuda"):
    """Row view (CSV) of the serving sweep: p99 in the time column, SLO-met
    goodput in the derived column."""
    rows = []
    for name, n, trace in SERVE_POINTS:
        _, _, drv = _serve_run(n, trace, device=device)
        r = drv.result(SERVE_SLO_US)
        rows.append((f"serve_{name}_p99", r.p99_us,
                     round(r.goodput_tok_s, 1)))
    return rows


def serve_summary(device="cuda") -> dict:
    """Deterministic serving trajectory for ``BENCH_protocol.json``: tail
    latency (p50/p99, higher is worse) and goodput (SLO-met tokens per
    virtual second, LOWER is worse) within tolerance, plus the protocol
    counters (round trips, KV hit/miss, int8 wire bytes, weight
    refreshes) pinned exactly — everything runs on virtual clocks over
    seeded traces, so any drift is a behavior change."""
    out = {}
    for name, n, trace in SERVE_POINTS:
        cl, fleet, drv = _serve_run(n, trace, device=device)
        r = drv.result(SERVE_SLO_US)
        st = fleet.stats()
        out[name] = {
            "p50_us": r.p50_us,
            "p99_us": r.p99_us,
            "goodput_tok_s": r.goodput_tok_s,
            "completed": r.completed,
            "slo_met": r.slo_met,
            "steps": st["steps"],
            "round_trips": cl.sim.net.round_trips,
            "kv_hits": st["kv"]["hits"],
            "kv_misses": st["kv"]["misses"],
            "wire_bytes": st["wire_bytes"],
            "weight_refreshes": st["weight_refreshes"],
        }
    return out


def clone_fastpath_guard(n_elems: int = 4096, reps: int = 30):
    """Microbenchmark guard for ``ownership._clone``: flat scalar containers
    must take the shallow fast path, not ``deepcopy``.  ``derived`` is the
    speedup of ``_clone`` over ``copy.deepcopy`` — regressions show up as a
    ratio near (or below) 1."""
    payloads = {
        "list": list(range(n_elems)),
        "dict": {i: float(i) for i in range(n_elems)},
    }
    rows = []
    for kind, data in payloads.items():
        t0 = time.perf_counter()
        for _ in range(reps):
            _clone(data)
        fast = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(reps):
            copy.deepcopy(data)
        deep = time.perf_counter() - t0
        rows.append((f"clone_{kind}_fastpath_speedup", fast / reps * 1e6,
                     round(deep / max(fast, 1e-9), 1)))
    return rows


def sanitize_overhead_summary(n_requests: int = 80, n_ops: int = 400) -> dict:
    """Wall-clock cost of the runtime borrow/cid sanitizer
    (``Cluster(sanitize=True)``, ``docs/analysis.md``) on two app kernels.

    Diagnostics only — **never gated**: wall-clock varies across runners,
    and the *simulated* trajectory is identical by construction (the
    sanitizer observes guard/verb events, it charges no cost).  The
    ``span_identical`` bools are the interesting part: they assert the
    observation-only contract on every refresh of ``BENCH_protocol.json``.
    """
    out: dict = {}
    prev = os.environ.get("REPRO_SANITIZE")
    try:
        for name, fn, kw in (
            ("socialnet", run_socialnet, dict(n_requests=n_requests)),
            ("kvstore", run_kvstore,
             dict(n_keys=256, n_ops=n_ops, txn_frac=0.3)),
        ):
            runs = {}
            for mode in ("off", "on"):
                os.environ["REPRO_SANITIZE"] = "1" if mode == "on" else "0"
                t0 = time.perf_counter()
                r = fn(4, "drust", **kw)
                wall = time.perf_counter() - t0
                runs[mode] = (wall, r.makespan_us)
            out[name] = {
                "wall_ms_off": round(runs["off"][0] * 1e3, 1),
                "wall_ms_on": round(runs["on"][0] * 1e3, 1),
                "overhead_x": round(
                    runs["on"][0] / max(runs["off"][0], 1e-9), 2),
                "trace_events": len(Sanitizer.last.trace),
                "span_identical": runs["off"][1] == runs["on"][1],
            }
    finally:
        if prev is None:
            os.environ.pop("REPRO_SANITIZE", None)
        else:
            os.environ["REPRO_SANITIZE"] = prev
    return out


def all_rows(device="cuda"):
    rows = []
    for backend in ("drust", "gam", "grappa"):
        rows += rows_for(backend)
    rows += group_fetch_sweep()
    rows += read_many_sweep()
    rows += writeback_depth_sweep()
    rows += qp_writeback_sweep()
    rows += qp_readmany_sweep()
    rows += coalesce_budget_sweep()
    rows += recovery_sweep()
    rows += serve_slo_sweep(device)
    rows += clone_fastpath_guard()
    return rows


def main(argv=None) -> None:
    """``python -m repro_torch.benchmarks.protocol_micro [--device cpu]``:
    every row, as the reference's ``__main__`` prints them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    for name, us, n in all_rows(resolve_device(a.device)):
        print(f"{name}: {n}  ({us:.2f} us)")


if __name__ == "__main__":
    main()
