"""DRust runtime system (§4.2): threads, cooperative scheduler, controller.

* ``Thread`` — a user-space green thread with a private (globally aligned)
  stack address range, its own virtual clock, and the access statistics the
  controller's balancing policies need.
* ``Scheduler`` — spawn / spawn_to / join / migrate.  Context switches are
  function calls (cooperative, non-preemptive); migration ships the function
  pointer + saved registers + stack, which keeps its address (Fig. 3).
* ``GlobalController`` — daemon on the launch server: probes per-server
  CPU/memory, picks allocation & spawn targets, and resolves imbalance by
  migrating threads (§4.2.2 policies: mem>90% → evict the biggest-heap
  thread; cpu>90% → move remote-heavy threads toward their data).
* ``CoalescePolicy`` / ``DerefCoalescer`` — the adaptive deref-coalescing
  policy (``Cluster(coalesce="auto")``): non-owning derefs of remote
  objects *register* inside the thread's scheduler quantum instead of
  fetching, and the whole pending set materializes as per-source
  ``read_many`` doorbells when the quantum closes — at an adaptive
  count/byte budget, at a borrow conflict, or at an explicit settle point.
  Registration takes the immutable borrow immediately, so the payload is
  frozen until the flush (ownership makes the deferral coherence-exact,
  not approximate); only the *cost* of the fetch is deferred.
* ``Cluster`` — wires Sim + GlobalHeap + one protocol backend together; the
  single entry point used by the applications and benchmarks.
"""

from __future__ import annotations

import itertools
import math
import os
import warnings
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable

from . import addr as A
from . import baselines as _baselines      # noqa: F401 — registers gam/grappa
from .heap import GlobalHeap
from .net import CostModel, Sim
from .ownership import _clone              # importing also registers drust
from .protocol import Region, backend_class


class Thread:
    _ids = itertools.count()

    def __init__(self, server: int, fn: Callable | None = None,
                 args: tuple = (), stack_bytes: int = 1 << 20):
        self.tid = next(Thread._ids)
        self.server = server
        self.fn, self.args = fn, args
        self.stack_addr = A.STACK_BASE + self.tid * A.STACK_SIZE
        self.stack_bytes = stack_bytes          # live stack payload (for migration)
        self.t_us = 0.0                          # virtual clock
        self.local_heap_bytes = 0                # controller: mem policy input
        self.remote_accesses: Counter = Counter()  # server -> count (cpu policy)
        self.migrations = 0
        self.done = False
        self.result: Any = None

    def note_remote(self, server: int) -> None:
        self.remote_accesses[server] += 1

    def hottest_remote(self) -> int | None:
        if not self.remote_accesses:
            return None
        return self.remote_accesses.most_common(1)[0][0]


class Scheduler:
    """Cooperative user-space scheduler + migration (§4.2.1)."""

    def __init__(self, cluster: "Cluster"):
        self.cluster = cluster
        self.threads: list[Thread] = []
        self.migration_log: list[tuple[int, int, int, float]] = []

    def spawn(self, fn: Callable, *args, server: int | None = None,
              parent: Thread | None = None) -> Thread:
        if server is None:
            server = self.cluster.controller.pick_spawn_server()
        th = Thread(server, fn, args)
        self.threads.append(th)
        if parent is not None:
            # closure + captured pointers ship to the target server
            if parent.server != server:
                self.cluster.sim.rpc(parent, server, req_bytes=256)
            th.t_us = max(th.t_us, parent.t_us)
        san = self.cluster.backend.sanitizer
        if san is not None:
            san.note_spawn(parent, th)
        return th

    def spawn_to(self, box, fn: Callable, *args,
                 parent: Thread | None = None) -> Thread:
        """Data-affinity spawn (§4.1.3): run where ``box``'s object lives.

        Resolved through the backend's ``locate`` — the *current* owner
        location — not the allocation-time home: after an ownership
        ``transfer`` or a write-move the home partition is stale and a
        home-resolved spawn would make every deref remote."""
        server = self.cluster.backend.locate(box)
        return self.spawn(fn, *args, server=server, parent=parent)

    def spawn_near(self, handles, fn: Callable, *args,
                   parent: Thread | None = None) -> Thread:
        """Placement-guided spawn for a *set* of handles (a region's
        pin/prefetch hint set): run on the weighted plurality of the
        handles' current locations, ties to the lowest server id."""
        votes: dict[int, float] = {}
        for h in handles:
            s = self.cluster.backend.locate(h)
            votes[s] = votes.get(s, 0.0) + 1.0
        if not votes:
            return self.spawn(fn, *args, parent=parent)
        server = max(sorted(votes), key=lambda s: votes[s])
        return self.spawn(fn, *args, server=server, parent=parent)

    def run(self, th: Thread) -> Any:
        th.result = th.fn(th, *th.args)
        cl = self.cluster
        if cl.backend_drust and cl.drust.coalescer is not None:
            cl.drust.coalescer.flush(th)     # quantum closes with the fn
        th.done = True
        return th.result

    def run_all(self) -> None:
        for th in self.threads:
            if not th.done and th.fn is not None:
                self.run(th)

    def join(self, th: Thread, waiter: Thread | None = None) -> Any:
        if not th.done and th.fn is not None:
            self.run(th)
        if waiter is not None:
            waiter.t_us = max(waiter.t_us, th.t_us)
        san = self.cluster.backend.sanitizer
        if san is not None and waiter is not None:
            san.note_join(th, waiter)
        return th.result

    def retire(self, th: Thread) -> None:
        """Thread leaves the pool (elastic rescale / worker shutdown): mark
        done and clear the completion plane's per-thread state so a future
        thread reusing the id cannot inherit stale write-back tails or QP
        rings.  The retiree's in-flight write-backs stay in the makespan."""
        th.done = True
        cl = self.cluster
        if cl.backend_drust and cl.drust.coalescer is not None:
            cl.drust.coalescer.flush(th)     # quantum closes with the thread
        # Guard-leak checkpoint: a thread must not leave the pool holding
        # live borrows (the borrow would pin remote state forever).  Under
        # sanitize this raises with provenance; otherwise it warns.
        san = cl.backend.sanitizer
        if san is not None:
            san.check_thread(th, "retire")
        else:
            leaked = getattr(cl.backend, "open_by_tid", {}).get(th.tid, 0)
            if leaked:
                warnings.warn(
                    f"thread {th.tid} retired with {leaked} open guard(s) — "
                    f"borrows leak past the thread lifetime "
                    f"(run with Cluster(sanitize=True) to locate them)",
                    RuntimeWarning, stacklevel=2)
        cl.sim.wb.forget(th.tid)
        cl.controller.thread_table.pop(th.tid, None)

    def migrate(self, th: Thread, dst: int) -> float:
        """Ship fn pointer + registers + stack; stack address is preserved
        because stack ranges are globally aligned (Fig. 3).  Returns the
        migration latency in us (paper measures ~218 us for ~1 MiB stacks)."""
        sim = self.cluster.sim
        src = th.server
        if src == dst:
            return 0.0
        cl = self.cluster
        if cl.backend_drust and cl.drust.coalescer is not None:
            cl.drust.coalescer.flush(th)     # quantum closes on migration
        san = cl.backend.sanitizer
        if san is not None:
            # A migrating stack must not carry live borrows (the borrowed
            # pointer would dangle across the move).
            san.check_thread(th, "migrate", detail=f"server {src}->{dst}")
        lat = (sim.cost.two_sided_rtt_us * 2                    # ctrl handshake
               + sim.cost.xfer_us(th.stack_bytes + 512)         # stack + regs
               + sim.cost.msg_proc_us * 2)
        th.t_us += lat
        sim.net.two_sided_msgs += 4
        sim.net.bytes_moved += th.stack_bytes + 512
        sim.servers[dst].cpu_busy_us += sim.cost.msg_proc_us
        th.server = dst
        th.migrations += 1
        th.local_heap_bytes = 0
        # Telemetry decay: the counters describe the *old* neighborhood.
        # Accesses to ``dst`` are local now (that entry would make the
        # thread look remote-heavy on the server it just moved to, and
        # ``balance`` would bounce it right back); the rest halve so the
        # next round steers on post-migration evidence.
        th.remote_accesses.pop(dst, None)
        for s in list(th.remote_accesses):
            kept = th.remote_accesses[s] // 2
            if kept:
                th.remote_accesses[s] = kept
            else:
                del th.remote_accesses[s]
        self.migration_log.append((th.tid, src, dst, lat))
        self.cluster.controller.thread_table[th.tid] = dst
        return lat


class GlobalController:
    """Cluster-wise resource daemon (§4.2.2)."""

    MEM_HI = 0.90
    CPU_HI = 0.90
    PROBE_MISS_LIMIT = 3      # missed liveness probes before declaring death

    def __init__(self, cluster: "Cluster"):
        self.cluster = cluster
        self.thread_table: dict[int, int] = {}     # tid -> server
        self.missed_probes: dict[int, int] = {}    # server -> misses in a row
        self._rr = 0

    # -- probing ----------------------------------------------------------
    def mem_frac(self, s: int) -> float:
        return self.cluster.heap.partitions[s].frac_used

    def cpu_frac(self, s: int, horizon_us: float) -> float:
        if horizon_us <= 0:
            return 0.0
        sim = self.cluster.sim
        return sim.servers[s].cpu_busy_us / (sim.cores * horizon_us)

    def probe_failures(self, th) -> list[int]:
        """One liveness-probe round of the controller daemon: every
        unresponsive (``failing``) server costs the prober one probe
        timeout and bumps its miss counter; at ``PROBE_MISS_LIMIT`` the
        failure is *declared* and recovery fails the server over.  Returns
        the servers declared dead this round."""
        cl = self.cluster
        sim = cl.sim
        declared: list[int] = []
        for s in sorted(sim.failing):
            sim.busy(th, sim.cost.retry_timeout_us)    # the probe timed out
            sim.net.degraded_retries += 1
            self.missed_probes[s] = self.missed_probes.get(s, 0) + 1
            if self.missed_probes[s] >= self.PROBE_MISS_LIMIT:
                self.missed_probes.pop(s)
                declared.append(s)
                if getattr(cl, "recovery", None) is not None:
                    cl.recovery.fail_over(s, th)
                else:
                    sim.declare_failed(s)
        # a server that answers again clears its strike counter
        for s in list(self.missed_probes):
            if s not in sim.failing:
                self.missed_probes.pop(s)
        return declared

    # -- placement policies -------------------------------------------------
    def _alive(self) -> list[int]:
        return self.cluster.sim.alive_servers()

    def pick_alloc_server(self, prefer: int, size: int) -> int:
        """Local-first; under pressure, the most vacant *alive* server
        (§4.2.1).  Lost servers' partition indices are rehosted read-mostly
        — new allocations never land there."""
        part = self.cluster.heap.partitions[prefer]
        if (part.used + size) / part.capacity < self.MEM_HI:
            return prefer
        return min(self._alive(), key=self.mem_frac)

    def pick_spawn_server(self) -> int:
        """Least-loaded alive server by CPU busy; round-robin tiebreak."""
        sim = self.cluster.sim
        alive = self._alive()
        lo = min(sim.servers[s].cpu_busy_us for s in alive)
        cands = [s for s in alive if sim.servers[s].cpu_busy_us == lo]
        self._rr += 1
        return cands[self._rr % len(cands)]

    # -- straggler mitigation --------------------------------------------
    STRAGGLER_FACTOR = 2.0

    def detect_stragglers(self) -> list[int]:
        """Servers whose observed compute rate lags the fleet median by
        more than STRAGGLER_FACTOR (the controller's periodic probe)."""
        alive = self._alive()
        slow = self.cluster.sim.slowdown
        rates = sorted(slow[s] for s in alive)
        med = rates[len(rates) // 2]
        return [s for s in alive if slow[s] > med * self.STRAGGLER_FACTOR]

    def mitigate_stragglers(self) -> int:
        """Drain threads off straggling servers onto the fastest peers —
        the work-conserving answer while the node is replaced (its heap
        partition stays readable; only compute moves)."""
        moved = 0
        stragglers = set(self.detect_stragglers())
        if not stragglers:
            return 0
        healthy = [s for s in self._alive() if s not in stragglers]
        if not healthy:
            return 0
        sim = self.cluster.sim
        victims = [t for t in self.cluster.scheduler.threads
                   if not t.done and t.server in stragglers]
        # Spread by *projected* load: migration barely moves cpu_busy_us,
        # so re-reading the live snapshot per victim would send the whole
        # drained population to the single fastest peer.  Account each
        # migrated thread's estimated remaining work at its destination
        # before placing the next one.
        projected = {s: sim.servers[s].cpu_busy_us for s in sorted(healthy)}
        per_thread_est = {
            s: max(sim.servers[s].cpu_busy_us
                   / max(1, sum(1 for v in victims if v.server == s)), 1.0)
            for s in stragglers}
        for t in victims:
            dst = min(projected, key=lambda s: (projected[s], s))
            projected[dst] += per_thread_est[t.server]
            self.cluster.scheduler.migrate(t, dst)
            moved += 1
        return moved

    # -- balancing ----------------------------------------------------------
    def balance(self, horizon_us: float) -> int:
        """One balancing round; returns number of migrations performed."""
        cl, moved = self.cluster, 0
        threads = [t for t in cl.scheduler.threads if not t.done]
        alive = self._alive()
        for s in alive:
            if self.mem_frac(s) > self.MEM_HI:
                if cl.backend_drust:
                    # incremental CLOCK eviction toward the watermark — only
                    # the excess bytes are reclaimed, so warm copies below
                    # the high-water mark survive the pressure event
                    part = cl.heap.partitions[s]
                    excess = part.used - int(self.MEM_HI * part.capacity)
                    cl.drust.evict_caches(s, target_bytes=excess)
                victims = sorted((t for t in threads if t.server == s),
                                 key=lambda t: -t.local_heap_bytes)
                if victims and self.mem_frac(s) > self.MEM_HI:
                    dst = min(alive, key=self.mem_frac)
                    if dst != s:
                        cl.scheduler.migrate(victims[0], dst)
                        moved += 1
            if self.cpu_frac(s, horizon_us) > self.CPU_HI:
                remote_heavy = sorted(
                    (t for t in threads if t.server == s and t.remote_accesses),
                    key=lambda t: -sum(t.remote_accesses.values()))
                for t in remote_heavy[:1]:
                    dst = t.hottest_remote()
                    if dst is None or dst not in alive:
                        continue
                    if self.cpu_frac(dst, horizon_us) > self.CPU_HI:
                        dst = min(alive,
                                  key=lambda x: self.cpu_frac(x, horizon_us))
                    if dst != s:
                        cl.scheduler.migrate(t, dst)
                        moved += 1
        return moved


@dataclass
class CoalescePolicy:
    """Knobs for the adaptive deref coalescer.

    In this cost model batching within one quantum is monotone: a flush's
    per-server doorbells already overlap (and, under ooo, stripe across
    the QPs), so each extra coalesced deref only amortizes the doorbell
    base latency further — the makespan curve saturates at an
    *amortization knee*.  What a bigger quantum does cost is deref-latency
    **exposure**: the first registered deref materializes only when the
    quantum closes, and on bulk mixes that window grows linearly.  The
    adaptive budget therefore closes the quantum at the knee:

        ``n* = ceil(base / (amortize_frac * per_verb_cost))``

    where the marginal per-verb cost is the QP engine occupancy
    ``max(xfer(EWMA object size), qp_msg_us)`` under the out-of-order
    plane.  Small-object mixes → per-verb cost is the NIC message rate →
    large quanta (the base latency is the whole cost); bulk mixes →
    bandwidth dominates → moderate quanta (past the knee batching buys
    ~nothing while exposure keeps growing).  Under the legacy plane there
    is no per-QP serialization to price, so the budget sits at
    ``pending_cap`` and quanta close at conflicts / settle points.  The
    static knobs (``max_pending`` / ``max_bytes``) override adaptation —
    that is what the ``coalesce_sweep`` benchmark sweeps against.
    """

    max_pending: int | None = None     # static count budget (None = adaptive)
    max_bytes: int | None = None       # static byte budget (None = off)
    amortize_frac: float = 0.03        # knee target: base <= frac * marginal
    pending_cap: int = 64              # adaptive count budget ceiling
    ewma_alpha: float = 0.25           # deref-size tracker smoothing
    # Latency-exposure SLO: force a flush once the OLDEST registered deref
    # has been pending longer than this budget (us of virtual time).  The
    # count/byte budgets bound doorbell *size*; this bounds how long a
    # registered deref's materialization can be deferred — the exposure
    # cost the amortization knee trades against.  None = no SLO.
    max_expose_us: float | None = None

    def budgets(self, cost, qps: int, ooo: bool,
                ewma_bytes: float) -> tuple[int, int | None]:
        """(count budget, byte budget or None) for the current mix."""
        n = self.max_pending
        if n is None:
            if not ooo:                # legacy plane: bigger is always better
                n = self.pending_cap
            else:                      # price the per-QP engine occupancy
                per_verb = max(cost.xfer_us(max(ewma_bytes, 1.0)),
                               cost.qp_msg_us)
                n = math.ceil(cost.one_sided_base_us
                              / (self.amortize_frac * per_verb))
                n = max(1, min(self.pending_cap, n))
        return n, self.max_bytes


class DerefCoalescer:
    """Per-thread pending-deref registry behind ``Cluster(coalesce="auto")``.

    ``register`` takes the immutable borrow and queues the deref;
    ``flush`` closes the thread's quantum — the queued boxes go through
    ``DrustRuntime.read_many`` (identical verbs, bytes, and end state as
    the hand-written drain-then-fetch choreography), then the registration
    borrows drop.  Conflicting ops (mutable borrow / owner write /
    transfer / drop) call ``flush_box`` through the ownership layer so the
    registered borrows can never turn a legal program into a BorrowError.
    """

    def __init__(self, rt, policy: CoalescePolicy | None = None):
        self.rt = rt
        self.policy = policy or CoalescePolicy()
        self.pending: dict[int, tuple[Any, list]] = {}  # tid -> (th, [(box, ref)])
        self.pending_bytes: dict[int, int] = {}
        self.first_reg_t: dict[int, float] = {}         # tid -> oldest reg time
        self.by_box: dict[Any, set[int]] = {}           # box -> tids (identity)
        self.ewma_bytes = 0.0
        self.flushes = 0
        self.flushed_derefs = 0
        self.registered = 0
        self.expose_flushes = 0                         # SLO-forced flushes
        self.align = False      # placement: merge sibling threads' pending
        #                         derefs for the same destinations at flush

    def wants(self, th, box) -> bool:
        """Registration applies to non-owning derefs of *cold remote*
        objects; local, warm, speculative-hit, dropped, and mutably
        borrowed boxes take the eager path (which raises/materializes
        exactly as the manual plane would)."""
        if box.dropped or box.live_mut:
            return False
        if A.server_of(box.g) == th.server:
            return False
        return box.g not in self.rt.caches[th.server].entries

    def register(self, th, box) -> Any:
        """Queue a deref; returns a *snapshot* of the payload immediately —
        the borrow freezes it, so the bytes cannot differ from what the
        flush materializes, and the clone matches the manual plane's
        semantics (a reader holds a copy, never an alias of the owner's
        heap object).  Fetch cost is charged at the flush."""
        rt = self.rt
        tid = th.tid
        ent = self.pending.get(tid)
        if ent is None:
            ent = (th, [])
            self.pending[tid] = ent
            self.pending_bytes[tid] = 0
        _, items = ent
        if any(b is box for b, _ in items):
            # re-deref inside the same quantum: charged like a warm re-read
            sim = rt.sim
            sim.deref_check(th)
            sim.busy(th, sim.cost.hashmap_us)
            sim.local_access(th)
            return _clone(rt.heap.get(A.clear_color(box.g)).data)
        ref = box.borrow(th)
        items.append((box, ref))
        self.by_box.setdefault(box, set()).add(tid)
        self.first_reg_t.setdefault(tid, th.t_us)
        nbytes = rt.heap.group_bytes(A.clear_color(box.g))
        self.pending_bytes[tid] += nbytes
        a = self.policy.ewma_alpha
        self.ewma_bytes = (nbytes if self.ewma_bytes == 0.0
                           else (1 - a) * self.ewma_bytes + a * nbytes)
        self.registered += 1
        n_budget, b_budget = self.policy.budgets(
            rt.sim.cost, rt.sim.qps, rt.sim.ooo, self.ewma_bytes)
        expose = self.policy.max_expose_us
        if (len(items) >= n_budget
                or (b_budget is not None
                    and self.pending_bytes[tid] >= b_budget)):
            self.flush(th)
        elif (expose is not None
                and th.t_us - self.first_reg_t[tid] >= expose):
            # Latency-exposure SLO: the oldest registered deref has been
            # deferred past the budget — close the quantum now.
            self.expose_flushes += 1
            self.flush(th)
        return _clone(rt.heap.get(A.clear_color(box.g)).data)

    def flush(self, th) -> int:
        """Close ``th``'s quantum: one coalesced ``read_many`` over the
        pending set, then the registration borrows drop."""
        ent = self.pending.pop(th.tid, None)
        self.pending_bytes.pop(th.tid, None)
        self.first_reg_t.pop(th.tid, None)
        if not ent:
            return 0
        _, items = ent
        for box, _ in items:
            tids = self.by_box.get(box)
            if tids is not None:
                tids.discard(th.tid)
                if not tids:
                    self.by_box.pop(box, None)
        merged: list[tuple[Any, Any, Any]] = []         # (oth, box, ref)
        if self.align and self.pending:
            # Cross-thread quantum alignment (placement subsystem): sibling
            # threads on the same server with pending derefs bound for the
            # destinations this flush is already dialing join the same
            # read_many — one doorbell per source instead of one per
            # quantum.  The payload lands in the shared per-server cache,
            # so the end state is identical to the siblings flushing on
            # their own; only the doorbell count drops.  Their never-
            # deref'd registration borrows release here (no cache pin).
            dests = {A.server_of(b.g) for b, _ in items}
            for tid in sorted(self.pending):
                oth, oitems = self.pending[tid]
                if oth.server != th.server:
                    continue
                take = [(b, r) for b, r in oitems
                        if A.server_of(b.g) in dests]
                if not take:
                    continue
                keep = [(b, r) for b, r in oitems
                        if A.server_of(b.g) not in dests]
                if keep:
                    self.pending[tid] = (oth, keep)
                    self.pending_bytes[tid] -= sum(
                        self.rt.heap.group_bytes(A.clear_color(b.g))
                        for b, _ in take)
                else:
                    self.pending.pop(tid)
                    self.pending_bytes.pop(tid, None)
                    self.first_reg_t.pop(tid, None)
                for b, r in take:
                    tids = self.by_box.get(b)
                    if tids is not None:
                        tids.discard(tid)
                        if not tids:
                            self.by_box.pop(b, None)
                    merged.append((oth, b, r))
            self.rt.sim.net.quantum_merges += len(merged)
        if merged:
            # The least-loaded participant drives the shared doorbell (the
            # first thread to reach the flush point posts it; the others'
            # registrations ride along).  Driving rotates with load, so
            # the merged fetch work spreads across the sibling pool
            # instead of piling onto whichever tid sorts first.
            parts = {th.tid: th}
            for oth, _, _ in merged:
                parts[oth.tid] = oth
            driver = min(parts.values(), key=lambda t: (t.t_us, t.tid))
            self.rt.read_many(driver, [b for b, _ in items]
                              + [b for _, b, _ in merged])
        else:
            self.rt.read_many(th, [b for b, _ in items])
        for _, ref in items:
            ref.drop(th)
        for oth, _, ref in merged:
            ref.drop(oth)
        self.flushes += 1
        self.flushed_derefs += len(items) + len(merged)
        return len(items)

    def discard(self, th) -> int:
        """``th`` died mid-quantum (its server crashed): its registered
        derefs can never materialize — no doorbell may be posted from a
        dead server — so the registration borrows release *without* a
        ``read_many``.  Returns the number of derefs discarded."""
        ent = self.pending.pop(th.tid, None)
        self.pending_bytes.pop(th.tid, None)
        self.first_reg_t.pop(th.tid, None)
        if not ent:
            return 0
        _, items = ent
        for box, ref in items:
            tids = self.by_box.get(box)
            if tids is not None:
                tids.discard(th.tid)
                if not tids:
                    self.by_box.pop(box, None)
            ref.drop(th)         # registration never deref'd: no cache pin
        return len(items)

    def flush_box(self, box) -> None:
        """A mutable op is about to touch ``box``: close the quantum of
        every thread holding a registered deref on it (sorted by tid —
        deterministic)."""
        for tid in sorted(self.by_box.get(box, ())):
            ent = self.pending.get(tid)
            if ent is not None:
                self.flush(ent[0])

    def flush_all(self) -> int:
        """Settle point (end of trace / snapshot): close every quantum."""
        n = 0
        for tid in sorted(self.pending):
            ent = self.pending.get(tid)
            if ent is not None:
                n += self.flush(ent[0])
        return n


@dataclass
class PlacementPolicy:
    """Knobs for telemetry-driven placement (``Cluster(placement="auto")``).

    The guard layer feeds per-box access-locality counters (accessor
    server × box, attributed to the TBox tie root so affinity groups are
    judged — and moved — as one closure).  Weights decay by ``decay`` per
    quantum epoch (EWMA), so the window tracks the *current* phase, not
    the run's history.  When one server's weight dominates — at least
    ``min_weight`` absolute and ``dominance`` × the runner-up — and the
    payload lives elsewhere, the hot accessor pulls ownership to itself
    with a fence-scoped live migration (``DrustRuntime.migrate_here``).
    ``cooldown`` epochs of hysteresis after each move stop a contended box
    from ping-ponging between two comparably hot servers.
    """

    decay: float = 0.5          # per-epoch EWMA multiplier on counters
    min_weight: float = 3.0     # absolute weight floor to trigger a move
    dominance: float = 2.0      # hot server must beat the runner-up by this
    cooldown: int = 1           # epochs a box rests after migrating
    quantum_align: bool = True  # merge sibling same-destination doorbells
    # Write accesses vote with this weight.  Default 0: the drust
    # write-move already relocates an object to any remote writer, so a
    # write is always *local by construction* when its guard closes —
    # counting it would anchor the box wherever compute last touched it
    # and veto every read-affinity move.  Reads are what a static
    # placement cannot fix; they carry the vote.
    write_weight: float = 0.0


class PlacementTracker:
    """Access-locality telemetry + migration trigger behind
    ``Cluster(placement="auto")``.

    Installed as ``backend.placement``; ``ReadGuard``/``WriteGuard`` close
    call ``note_access`` — guard exit is the one point where the borrow
    just released, so a triggered migration can never race the recording
    access's own borrow.  Migration is additionally suppressed while any
    borrow in the moving closure is live (``migrate_here`` re-checks after
    flushing registered derefs) and during recovery quiesce.
    """

    def __init__(self, cluster: "Cluster",
                 policy: PlacementPolicy | None = None):
        self.cluster = cluster
        self.policy = policy or PlacementPolicy()
        self.epoch = 0
        # root box -> [weights {server: w}, last-decay epoch, last-mig epoch]
        self._rec: dict[Any, list] = {}
        self.samples = 0
        self.migrations = 0

    def tick(self) -> None:
        """Close a quantum epoch: subsequent accesses see decayed weights
        (applied lazily per box on its next access)."""
        self.epoch += 1

    def weights(self, box) -> dict[int, float]:
        """Current (decayed) per-server weights for ``box``'s tie root."""
        root = self.cluster.drust.placement_root(box)
        rec = self._rec.get(root)
        if rec is None:
            return {}
        f = self.policy.decay ** (self.epoch - rec[1])
        return {s: w * f for s, w in rec[0].items()}

    def note_access(self, th, h, write: bool = False) -> None:
        cl = self.cluster
        if cl.recovery is not None and cl.recovery.quiescing:
            return                       # no placement churn mid fail-over
        rt = cl.drust
        root = rt.placement_root(h)
        if root.dropped or root.lost:
            self._rec.pop(root, None)
            return
        src = A.server_of(root.g)
        if src != th.server:
            th.note_remote(src)          # controller cpu-policy telemetry
        p = self.policy
        rec = self._rec.get(root)
        if rec is None:
            rec = [{}, self.epoch, -(1 << 30)]
            self._rec[root] = rec
        w = rec[0]
        if rec[1] != self.epoch:         # lazy EWMA decay since last touch
            f = p.decay ** (self.epoch - rec[1])
            for s in list(w):
                w[s] *= f
                if w[s] < 1e-6:
                    del w[s]
            rec[1] = self.epoch
        vote = p.write_weight if write else 1.0
        if vote > 0.0:
            w[th.server] = w.get(th.server, 0.0) + vote
        self.samples += 1
        if not w:
            return
        if self.epoch - rec[2] < p.cooldown:
            return                       # hysteresis: box rested recently
        hot = max(sorted(w), key=lambda s: w[s])
        if hot != th.server or hot == src:
            return   # only the hot accessor pulls, and only if remote
        whot = w[hot]
        second = max((v for s, v in w.items() if s != hot), default=0.0)
        if whot < p.min_weight or whot < p.dominance * second:
            return
        if rt.migrate_here(th, root):
            rec[2] = self.epoch
            rec[0] = {}                  # fresh window after the move
            self.migrations += 1

    def spawn_hint(self, handles) -> int | None:
        """Weighted-plurality location of a region's pin/prefetch hint
        set — the ``spawn_near`` placement target (None = no preference)."""
        votes: dict[int, float] = {}
        for h in handles:
            s = self.cluster.backend.locate(h)
            votes[s] = votes.get(s, 0.0) + 1.0
        if not votes:
            return None
        return max(sorted(votes), key=lambda s: votes[s])


class Cluster:
    """One simulated deployment: N servers, one protocol backend."""

    def __init__(self, n_servers: int, backend: str = "drust",
                 cores_per_server: int = 16, cost: CostModel | None = None,
                 partition_bytes: int | None = None, replicate: bool = False,
                 batch_io: bool = True, qps_per_thread: int = 1,
                 ooo: bool = False, coalesce: str = "manual",
                 coalesce_policy: CoalescePolicy | None = None,
                 placement: str = "static",
                 placement_policy: PlacementPolicy | None = None,
                 sanitize: bool | None = None):
        if coalesce not in ("manual", "auto"):
            raise ValueError(f"unknown coalesce mode {coalesce!r}")
        if placement not in ("static", "auto"):
            raise ValueError(f"unknown placement mode {placement!r}")
        self.sim = Sim(n_servers, cores_per_server, cost,
                       qps_per_thread=qps_per_thread, ooo=ooo)
        self.heap = GlobalHeap(n_servers, partition_bytes)
        self.partition_bytes = partition_bytes  # for elastic add_server
        self.backend_name = backend
        self.batch_io = batch_io
        self.channels: list = []               # auto mode: quantum-settled
        self.mutexes: list = []                # recovery: lock reconstruction
        # Every protocol engine implements the ProtocolBackend ABC and is
        # constructed uniformly from the registry; capability flags
        # (supports_*) replace backend-name special cases downstream.
        self.backend = backend_class(backend)(self.sim, self.heap,
                                              batch_io=batch_io)
        self.backend_drust = self.backend.supports_ownership
        if self.backend_drust:
            self.drust = self.backend
        # The deref coalescer needs the batched plane (it flushes through
        # read_many doorbells) and ownership-derived borrows (drust only);
        # channel send staging applies under "auto" for every backend.
        self.coalesce = coalesce
        if coalesce == "auto" and self.backend_drust and batch_io:
            self.drust.coalescer = DerefCoalescer(self.drust, coalesce_policy)
        # Telemetry-driven placement (opt-in: the default "static" keeps
        # every run byte-identical to the pre-placement planes).  The
        # tracker installs as ``backend.placement`` — the guard layer's
        # close hooks feed it — and flips the coalescer's cross-thread
        # quantum alignment on.
        self.placement_mode = placement
        self.placement: PlacementTracker | None = None
        if placement == "auto":
            if not self.backend_drust:
                raise RuntimeError(
                    "placement='auto' requires an ownership-capable backend")
            self.placement = PlacementTracker(self, placement_policy)
            self.backend.placement = self.placement
            if (self.drust.coalescer is not None
                    and self.placement.policy.quantum_align):
                self.drust.coalescer.align = True
        self.scheduler = Scheduler(self)
        self.controller = GlobalController(self)
        self.replicator = None
        if replicate and backend == "drust":
            from .fault import Replicator
            self.replicator = Replicator(self)
        # Crash fail-over pipeline (drust only: it reconciles ownership
        # state — borrows, guards, spec cids — the baselines don't track).
        self.recovery = None
        if self.backend_drust:
            from .fault import RecoveryManager
            self.recovery = RecoveryManager(self)
        # Runtime borrow/cid sanitizer (``repro_torch.analysis``): opt-in via the
        # ``sanitize`` flag or the ``REPRO_SANITIZE`` env var (so CI can run
        # an unmodified test subset under sanitize).  Observation only —
        # sanitize-off runs are byte-identical, sanitize-on runs add checks
        # and an event trace but never charge the cost model.
        if sanitize is None:
            sanitize = os.environ.get("REPRO_SANITIZE", "") not in ("", "0")
        self.sanitizer = None
        if sanitize:
            from repro_torch.analysis.sanitizer import Sanitizer
            self.sanitizer = Sanitizer(self)
            self.backend.sanitizer = self.sanitizer
            self.sim.tracer = self.sanitizer

    # elasticity ----------------------------------------------------------
    def add_server(self) -> int:
        """Elastic grow: a fresh server joins the live cluster — Sim stats
        + QP restripe, a new heap partition (the PGAS address space already
        reserves its range), an empty cache wired into the spec-disposition
        ledger, and a replica map if replication is on.  Returns the new
        server index.  Only the drust backend supports growing (the
        baselines size per-server state once, at construction)."""
        if not self.backend_drust:
            raise RuntimeError("elastic grow requires the drust backend")
        s = self.sim.add_server()
        part = self.heap.add_partition(self.partition_bytes)
        from .cache import LocalCache
        H = LocalCache(s, part)
        H.on_spec_drop = (
            lambda cid: self.drust._dispose_spec(cid, "invalidated"))
        self.drust.caches.append(H)
        if self.replicator is not None:
            self.replicator.add_server(s)
        return s

    # convenience ---------------------------------------------------------
    def main_thread(self, server: int = 0) -> Thread:
        th = Thread(server)
        self.scheduler.threads.append(th)
        return th

    def region(self, th, prefetch=(), pin=(), lease=()) -> Region:
        """``with cluster.region(th) as r:`` — scoped batching region.

        Entry applies the optional ``prefetch``/``pin``/``lease`` hints
        (prefetch/pin also available as ``r.prefetch(...)`` /
        ``r.pin(...)`` inside the scope; ``lease`` takes reader leases on
        ``DRwLock``s that persist past the region — see ``core/sync.py``);
        exit is a settle point for exactly this thread's pending work —
        registered derefs flush as ``read_many`` doorbells, staged channel
        sends ring, pins release (see ``protocol.Region``)."""
        return Region(self, th, prefetch=prefetch, pin=pin, lease=lease)

    def settle(self, th) -> None:
        """Per-thread settle point (a region exit): flush ``th``'s staged
        channel sends and close its coalescer quantum.  Idempotent — no-op
        under ``coalesce="manual"`` or when nothing is pending."""
        for ch in self.channels:
            ch.flush_sends(only_tid=th.tid)
        if self.backend_drust and self.drust.coalescer is not None:
            self.drust.coalescer.flush(th)

    def close_quanta(self) -> None:
        """End-of-quantum settle (runtime policy, not app code): flush
        staged channel sends and every pending coalesced deref.  Idempotent
        — a no-op under ``coalesce="manual"`` or when nothing is pending."""
        for ch in self.channels:
            ch.flush_sends()
        if self.backend_drust and self.drust.coalescer is not None:
            self.drust.coalescer.flush_all()
        if self.placement is not None:
            self.placement.tick()        # quantum epoch: counters decay

    def makespan_us(self) -> float:
        self.close_quanta()
        if self.sanitizer is not None:
            self.sanitizer.final_check()     # spec-cid ledger must balance
        return self.sim.makespan_us(self.scheduler.threads)

    def throughput(self, n_ops: int) -> float:
        """ops/sec given the virtual makespan."""
        span = self.makespan_us()
        return n_ops / (span / 1e6) if span > 0 else float("inf")
