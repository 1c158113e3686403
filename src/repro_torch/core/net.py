"""Deterministic cluster simulation substrate: virtual clocks + RDMA cost model.

The coherence protocols in this package are *control-plane* algorithms; their
message complexity is hardware-independent.  We execute them for real (real
heaps, caches, refcounts, payload bytes) and charge costs on a deterministic
virtual clock, calibrated against the paper's measurements (§3):

  * one-sided RDMA read of a 512 B object  ~ 3.6 us
  * GAM uncached 512 B read (directory)    ~ 16  us  (77% coherence overhead)
  * Table 2: local deref 364 cycles (plain) vs 395 cycles (DRust check)

Latency is charged to the *calling thread's* clock (its critical path); CPU
processing for two-sided messages is additionally charged to the serving
server's busy counter — that is what makes delegation (Grappa) bottleneck on
the home server of hot objects, reproducing the paper's skew results.

Batched I/O plane
-----------------
Two mechanisms take verbs off the per-object critical path:

* ``IOBatch`` (``Sim.batch()``) — *doorbell coalescing*: N one-sided verbs
  posted to the same destination in one doorbell ring cost ONE base latency
  plus the summed bandwidth terms plus a small per-verb issue cost
  (``doorbell_us``).  Counting: ``one_sided_reads``/``one_sided_writes`` and
  ``round_trips`` tick once per doorbell (one completion polled),
  ``batched_verbs`` counts the coalesced scatter/gather elements,
  ``doorbell_batches`` the rings.  This is how TBox affinity groups (§4.1.3)
  are fetched as one transfer.

* ``WritebackQueue`` (``Sim.wb``) — *async write-back pipelining*: posted
  WRITEs (e.g. DropMutRef's 8-byte owner write-back) charge only the issue
  cost (``wb_issue_us``) to the poster; the verb's completion is tracked and
  surfaces either at a fence (a synchronization point, e.g. ownership
  transfer) or in ``makespan_us`` — the cost is real, just off the critical
  path.

Multi-QP completion plane
-------------------------
Every posted verb draws a cluster-wide monotone **completion id** from
``Sim.next_cid()``.  How its completion *time* is computed depends on the
completion model:

* ``ooo=False`` (default) — the PR-1 legacy model: write-backs complete in
  post order per destination (one bandwidth-serialized wire per destination
  server), doorbells to distinct servers overlap.  This path reproduces the
  PR-1 plane exactly: byte-identical message/byte counters and virtual
  times equal to float-ulp level (pinned against golden PR-1 values by
  ``tests/test_net_invariants.py``).

* ``ooo=True`` — NIC-grade out-of-order completions.  Each thread owns
  ``qps_per_thread`` queue pairs; verbs/doorbells stripe round-robin across
  them (``qp_switches`` counts rings on a different QP than the last, at
  ``qp_switch_us`` CPU each).  Three deterministic serialization constraints
  shape every completion time:

    1. *per-QP engine*: a QP's WQEs are processed in order — each verb
       occupies the engine for ``max(bandwidth term, qp_msg_us)`` (the
       NIC's per-QP message-rate limit) before the next may start;
    2. *per-QP CQ order*: an RC QP's completions are strictly ordered, so a
       verb's completion time is floored by the QP's previous completion;
    3. *shared-link congestion*: all QPs of all threads share the
       destination server's link (bandwidth ``link_bw_bytes_per_us``) —
       every transfer's occupancy accumulates per server and a saturated
       link floors the makespan exactly like a saturated CPU
       (``Sim.link_xfer`` explains why it is capacity accounting rather
       than a busy-until queue).

  Completions of *different* QPs carry no ordering: a verb may complete
  before an earlier-posted verb on a sibling QP (``ooo_completions`` counts
  these inversions per posting thread).

Speculative prefetch rides the same completion plane: ``post_read`` posts a
one-sided READ doorbell off the critical path (``speculative_fetches``), the
runtime records the cid on the prefetched ``DBox``, and the fence is deferred
to the first *materialized* use (``late_fences``) — or never happens, when
ownership moves or the owner mutates before first use and the speculatively
fetched cache entry is invalidated instead (``wasted_prefetches``).

Fences wait on **completion ids**, not queues: ``fence(th, upto_id)`` blocks
``th`` until every still-pending verb with ``cid <= upto_id`` has completed
(a CQ-order fence may over-wait on unrelated earlier verbs — that is what a
cid fence means); ``fence_all(th)`` fences the entire pending window.  An
ownership transfer fences only the ids it actually depends on (the
write-backs recorded on the transferred box), leaving later verbs in flight.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field


class ServerLostError(RuntimeError):
    """A verb, borrow, or payload depended on a server that failed.

    Raised (a) by ``Sim`` when a verb targets a *declared-failed* server or
    exhausts the degraded-mode retry ladder against an unresponsive one, and
    (b) by the ownership layer when a guard touches a box whose payload died
    with its home server (open ``WriteGuard`` broken by fail-over, or a box
    that had no replica to restore from).  Structured — carries the server —
    so applications can re-drive work instead of pattern-matching strings.
    """

    def __init__(self, server: int, msg: str):
        super().__init__(f"server {server}: {msg}")
        self.server = server


@dataclass(frozen=True)
class CostModel:
    # Network (InfiniBand 40 Gbps, ConnectX-3-era latencies).
    one_sided_base_us: float = 3.5      # RDMA READ/WRITE verb latency floor
    two_sided_rtt_us: float = 3.0       # SEND/RECV round trip (control msgs)
    atomic_verb_us: float = 3.0         # RDMA FAA / CAS
    bw_bytes_per_us: float = 5000.0     # 40 Gbps ~ 5 GB/s payload bandwidth
    # CPU.
    ghz: float = 2.6                    # Xeon E5-2640 v3
    local_access_us: float = 0.14       # ~364 cycles: local object deref
    deref_check_us: float = 0.012       # ~31 cycles: DRust pointer check
    msg_proc_us: float = 1.0            # handler cost for a two-sided message
    dir_proc_us: float = 3.0            # directory state machine per hop (GAM)
    delegation_proc_us: float = 1.2     # delegated op execution (Grappa)
    alloc_us: float = 0.2               # heap allocator fast path
    hashmap_us: float = 0.05            # cache hashmap lookup/insert
    doorbell_us: float = 0.08           # per-verb issue cost inside a doorbell
    wb_issue_us: float = 0.15           # post an async write-back (no wait)
    # Multi-QP completion plane (ooo=True only).
    link_bw_bytes_per_us: float = 5000.0  # shared per-server link (NIC port)
    qp_msg_us: float = 0.5              # per-QP WQE engine occupancy per verb
    #   (the NIC's per-QP message-rate limit, ~2 M verbs/s: the reason
    #    multi-QP raises small-verb throughput even when bandwidth is idle)
    qp_switch_us: float = 0.02          # ring a doorbell on a different QP
    # Degraded mode (failure detection).  A verb posted to a server that is
    # failing-but-not-yet-declared times out and retries with exponential
    # backoff; after ``max_retries`` the error surfaces to the caller (and
    # feeds the controller's missed-probe counter).
    retry_timeout_us: float = 40.0      # per-attempt verb/probe timeout
    retry_backoff: float = 2.0          # backoff factor between attempts
    max_retries: int = 3                # attempts before declaring the verb lost

    def retry_penalty_us(self) -> float:
        """Total virtual time burned by a full retry ladder (timeout,
        backoff x2, ...): what a thread pays to discover a dead peer."""
        return sum(self.retry_timeout_us * self.retry_backoff ** i
                   for i in range(self.max_retries))

    def xfer_us(self, nbytes: int) -> float:
        return nbytes / self.bw_bytes_per_us

    def link_xfer_us(self, nbytes: int) -> float:
        return nbytes / self.link_bw_bytes_per_us

    def cycles_us(self, cycles: float) -> float:
        return cycles / (self.ghz * 1e3)


@dataclass
class ServerStats:
    cpu_busy_us: float = 0.0            # CPU time consumed on this server
    link_busy_us: float = 0.0           # shared-link occupancy (ooo model)
    bytes_in: int = 0
    bytes_out: int = 0
    msgs: int = 0


@dataclass
class NetStats:
    one_sided_reads: int = 0            # doorbells (completion events) polled
    one_sided_writes: int = 0
    two_sided_msgs: int = 0
    atomics: int = 0
    async_msgs: int = 0
    async_writebacks: int = 0           # pipelined WRITEs posted off-path
    invalidations: int = 0
    bytes_moved: int = 0
    round_trips: int = 0                # critical-path completions waited on
    doorbell_batches: int = 0           # doorbell rings (>= 1 verb each)
    batched_verbs: int = 0              # scatter/gather elements coalesced
    wb_drains: int = 0                  # fences that retired >= 1 verb
    fences: int = 0                     # fence/fence_all calls issued
    fenced_verbs: int = 0               # verbs retired by a completion fence
    ooo_completions: int = 0            # completions beating an earlier cid
    qp_switches: int = 0                # doorbell rung on a different QP
    speculative_fetches: int = 0        # prefetch doorbells posted off-path
    late_fences: int = 0                # fences deferred to first use
    wasted_prefetches: int = 0          # speculative entries killed unused
    # Telemetry-driven placement (core/runtime.py PlacementTracker; all
    # zero under placement="static", the default).
    owner_migrations: int = 0           # hot-accessor ownership pulls
    migration_round_trips: int = 0      # round trips spent inside those pulls
    quantum_merges: int = 0             # sibling derefs merged into one flush
    # Scalable synchronization (core/sync.py; zero on lock-free paths).
    closure_ships: int = 0              # delegated critical sections shipped
    convoy_completions: int = 0         # convoy-head completions polled
    delegated_sections: int = 0         # critical sections run at the home
    lease_grants: int = 0               # reader leases granted by a home
    lease_revokes: int = 0              # reader leases revoked by a writer
    # Recovery (crash fail-over; all zero on the no-failure path).
    orphaned_cids: int = 0              # pending verbs disposed at fail-over
    rehomed_boxes: int = 0              # objects restored from replica/checkpoint
    broken_locks: int = 0               # DMutex holders broken by fail-over
    lost_writes: int = 0                # dirty-at-crash objects (epoch revert)
    suspect_invalidations: int = 0      # dead-home cache copies scrubbed
    degraded_retries: int = 0           # retry attempts against failing servers
    recovery_makespan_us: float = 0.0   # virtual time of the last fail-over

    def total_msgs(self) -> int:
        return (self.one_sided_reads + self.one_sided_writes
                + self.two_sided_msgs + self.atomics + self.async_msgs)

    def critical_path_msgs(self) -> int:
        """Synchronous messages a thread actually waited on; DRust's
        invalidation/dealloc traffic, pipelined write-backs, and
        speculative prefetch READs are asynchronous by design and
        reported separately."""
        return (self.total_msgs() - self.async_msgs - self.async_writebacks
                - self.speculative_fetches - self.closure_ships)


@dataclass
class _Verb:
    """A posted-but-not-retired one-sided verb on the completion plane."""
    cid: int
    tid: int
    dst: int
    nbytes: int
    done_us: float
    is_read: bool = False     # speculative READ (vs async write-back WRITE)
    kind: str = "write"       # "write" | "closure" | "revoke" (WRITE flavors)


class IOBatch:
    """Doorbell-coalesced one-sided verbs (see module docstring).

    Verbs are staged with ``add_read``/``add_write`` and charged at
    ``commit(th)``: one base latency per (server, direction) doorbell plus
    summed bandwidth terms, per-verb issue cost additive.  Under the legacy
    completion model doorbells to distinct servers overlap (thread pays the
    max); under ``ooo=True`` the doorbells stripe round-robin across the
    thread's QPs — same-QP doorbells serialize on the QP engine, sibling-QP
    doorbells overlap, and every transfer serializes on the destination's
    shared link.
    """

    __slots__ = ("sim", "reads", "writes")

    def __init__(self, sim: "Sim"):
        self.sim = sim
        self.reads: dict[int, list[int]] = {}    # src server -> [nbytes]
        self.writes: dict[int, list[int]] = {}   # dst server -> [nbytes]

    def add_read(self, src_server: int, nbytes: int) -> None:
        self.reads.setdefault(src_server, []).append(nbytes)

    def add_write(self, dst_server: int, nbytes: int) -> None:
        self.writes.setdefault(dst_server, []).append(nbytes)

    @property
    def empty(self) -> bool:
        return not self.reads and not self.writes

    def n_verbs(self) -> int:
        return (sum(len(v) for v in self.reads.values())
                + sum(len(v) for v in self.writes.values()))

    def _count_doorbell(self, th, server: int, sizes: list[int],
                        is_read: bool) -> int:
        """Message/byte accounting for one doorbell (identical under both
        completion models); returns the doorbell's total byte count."""
        net, sim = self.sim.net, self.sim
        total = sum(sizes)
        for _ in sizes:
            sim.next_cid()               # every coalesced verb draws a cid
        if is_read:
            net.one_sided_reads += 1
            sim.servers[sim._serve(server)].bytes_out += total
            sim.servers[th.server].bytes_in += total
        else:
            net.one_sided_writes += 1
            sim.servers[sim._serve(server)].bytes_in += total
            sim.servers[th.server].bytes_out += total
        net.doorbell_batches += 1
        net.batched_verbs += len(sizes)
        net.round_trips += 1
        net.bytes_moved += total
        return total

    def commit(self, th) -> float:
        """Ring every doorbell; returns the critical-path latency charged."""
        if self.empty:
            return 0.0
        sim, cost = self.sim, self.sim.cost
        if sim.failed or sim.failing:     # all-or-nothing: gate before counting
            for server in (*self.reads, *self.writes):
                sim.check_reachable(th, server)
        if not sim.ooo:                  # legacy plane: PR-1 arithmetic
            issue = 0.0                  # CPU posts every WQE serially
            inflight = 0.0               # doorbells to distinct QPs overlap
            for server, sizes in self.reads.items():
                total = self._count_doorbell(th, server, sizes, is_read=True)
                issue += cost.doorbell_us * len(sizes)
                inflight = max(inflight,
                               cost.one_sided_base_us + cost.xfer_us(total))
            for server, sizes in self.writes.items():
                total = self._count_doorbell(th, server, sizes, is_read=False)
                issue += cost.doorbell_us * len(sizes)
                inflight = max(inflight,
                               cost.one_sided_base_us + cost.xfer_us(total))
            lat = issue + inflight
            th.t_us += lat
        else:                            # multi-QP out-of-order plane
            t0 = th.t_us
            dones: list[float] = []
            doorbells = ([(s, sz, True) for s, sz in self.reads.items()]
                         + [(s, sz, False) for s, sz in self.writes.items()])
            for server, sizes, is_read in doorbells:
                total = self._count_doorbell(th, server, sizes, is_read)
                th.t_us += cost.doorbell_us * len(sizes)    # serial WQE posts
                done = sim.qp_complete(th, server, total, n_verbs=len(sizes))
                if dones and done < max(dones):
                    sim.net.ooo_completions += 1
                dones.append(done)
            th.t_us = max(th.t_us, max(dones))   # sync commit: poll all CQs
            lat = th.t_us - t0
        self.reads.clear()
        self.writes.clear()
        return lat


class WritebackQueue:
    """Pipelined one-sided WRITEs charged off the critical path.

    ``post`` charges only the issue cost to the posting thread and returns
    the verb's **completion id**; the completion time comes from the active
    completion model (see module docstring).  Synchronization points wait on
    specific ids via ``fence``/``fence_all`` — anything never fenced
    surfaces as a floor on ``Sim.makespan_us``.
    """

    def __init__(self, sim: "Sim"):
        self.sim = sim
        self._bw_tail: dict[int, float] = {}     # legacy: dst -> wire busy-until
        self._bw_tail_rd: dict[int, float] = {}  # legacy: src -> read-wire tail
        self._pending: dict[int, _Verb] = {}     # cid -> verb, insertion = cid order
        self._retired: dict[int, float] = {}     # fenced cid -> completion time
        self._retired_hi = (0, 0.0)  # (highest retired cid, max retired done)
        self._tid_maxdone: dict[int, float] = {}  # max pending done per tid
        self._retired_floor = 0.0    # makespan floor from forgotten threads
        self._max_cid = 0            # highest cid ever posted on this queue
        self.posted = 0

    # ---- post ----------------------------------------------------------
    def post(self, th, dst_server: int, nbytes: int,
             kind: str = "write") -> int:
        """Post an async WRITE; returns its completion id.

        ``kind`` selects the WRITE flavor for counter purposes — identical
        cost model, different trajectory columns: ``"write"`` is a
        pipelined write-back (``async_writebacks``), ``"closure"`` is a
        delegated critical section shipped to a lock home
        (``closure_ships``, off the critical path — its completion is the
        convoy head's), ``"revoke"`` is a lease-revocation WRITE the
        writer fences immediately (counted on the critical path)."""
        sim, cost, net = self.sim, self.sim.cost, self.sim.net
        sim.check_reachable(th, dst_server, sync=False)
        th.t_us += cost.wb_issue_us
        tid = getattr(th, "tid", 0)
        cid = sim.next_cid()
        if not sim.ooo:
            # Legacy (PR-1) completion model: in-flight WRITEs overlap their
            # base latencies (deep NIC queue); only the bandwidth term
            # serializes per destination link, completions surface in post
            # order per destination.
            wire = (max(th.t_us, self._bw_tail.get(dst_server, 0.0))
                    + cost.xfer_us(nbytes))
            self._bw_tail[dst_server] = wire
            done = wire + cost.one_sided_base_us
        else:
            done = sim.qp_complete(th, dst_server, nbytes)
            # Out-of-order completion: this verb beats an earlier-posted,
            # still-pending verb of the same thread (on a sibling QP).
            prior_max = self._pending_maxdone(tid)
            if prior_max > done:
                net.ooo_completions += 1
            self._tid_maxdone[tid] = max(prior_max, done)
        self._pending[cid] = _Verb(cid, tid, dst_server, nbytes, done,
                                   kind=kind)
        self._max_cid = cid
        self.posted += 1
        net.one_sided_writes += 1
        if kind == "closure":
            net.closure_ships += 1
        elif kind != "revoke":
            net.async_writebacks += 1
        net.bytes_moved += nbytes
        sim.servers[sim._serve(dst_server)].bytes_in += nbytes
        sim.servers[th.server].bytes_out += nbytes
        if sim.tracer is not None:
            sim.tracer.note_post(th, cid, dst_server, nbytes, kind)
        return cid

    def post_read(self, th, src_server: int, nbytes: int,
                  n_verbs: int = 1) -> int:
        """Post a *speculative* one-sided READ doorbell (``n_verbs``
        coalesced WQEs pulling ``nbytes`` total from ``src_server``) and
        return its completion id.  The poster pays only the issue cost —
        the completion surfaces at a fence (the deferred first-use fence,
        an ownership-transfer dependency, or B.4 dealloc) or as a floor on
        ``makespan_us``.  Same completion models as ``post``; the legacy
        plane serializes reads on a per-*source* wire, independent of the
        write-back tails (READs come out of a link, WRITEs go into it)."""
        sim, cost, net = self.sim, self.sim.cost, self.sim.net
        sim.check_reachable(th, src_server, sync=False)
        th.t_us += cost.wb_issue_us + cost.doorbell_us * (n_verbs - 1)
        tid = getattr(th, "tid", 0)
        cid = sim.next_cid()
        if not sim.ooo:
            wire = (max(th.t_us, self._bw_tail_rd.get(src_server, 0.0))
                    + cost.xfer_us(nbytes))
            self._bw_tail_rd[src_server] = wire
            done = wire + cost.one_sided_base_us
        else:
            done = sim.qp_complete(th, src_server, nbytes, n_verbs=n_verbs)
            prior_max = self._pending_maxdone(tid)
            if prior_max > done:
                net.ooo_completions += 1
            self._tid_maxdone[tid] = max(prior_max, done)
        self._pending[cid] = _Verb(cid, tid, src_server, nbytes, done,
                                   is_read=True)
        self._max_cid = cid
        self.posted += 1
        net.one_sided_reads += 1
        net.speculative_fetches += 1
        net.bytes_moved += nbytes
        sim.servers[sim._serve(src_server)].bytes_out += nbytes
        sim.servers[th.server].bytes_in += nbytes
        if sim.tracer is not None:
            sim.tracer.note_post(th, cid, src_server, nbytes, "read",
                                 is_read=True)
        return cid

    # ---- fences --------------------------------------------------------
    @property
    def pending_completion_us(self) -> float:
        t = max((v.done_us for v in self._pending.values()), default=0.0)
        return max(t, self._retired_floor)

    def _pending_maxdone(self, tid: int) -> float:
        """Max completion time among ``tid``'s pending verbs — incrementally
        maintained on post, invalidated when a fence/forget removes the
        thread's verbs, recomputed lazily (keeps the inversion check O(1)
        per post instead of a pending-set scan)."""
        cached = self._tid_maxdone.get(tid)
        if cached is None:
            cached = max((v.done_us for v in self._pending.values()
                          if v.tid == tid), default=0.0)
            self._tid_maxdone[tid] = cached
        return cached

    def _retire(self, cid: int, done_us: float) -> None:
        self._retired[cid] = done_us
        hi_cid, hi_done = self._retired_hi
        self._retired_hi = (max(hi_cid, cid), max(hi_done, done_us))

    def _retired_before(self, upto_id: int) -> float:
        """Max completion time among retired cids <= upto_id.  O(1) when the
        fence covers the whole retirement frontier (the common case — new
        fences use fresh, higher cids); the scan only runs for a fence
        scoped below an already-retired cid."""
        hi_cid, hi_done = self._retired_hi
        if upto_id >= hi_cid:
            return hi_done
        return max((d for c, d in self._retired.items() if c <= upto_id),
                   default=0.0)

    def fence(self, th, upto_id: int) -> float:
        """Completion-id fence: block ``th`` until every verb with
        ``cid <= upto_id`` has completed.  Pending verbs in that range
        retire; verbs another thread's fence already retired still gate
        ``th`` — their completion *times* are kept in ``_retired`` so a
        dependent fence waits even when it is not the first to poll the
        cid (otherwise an ownership transfer could ship before a
        write-back another thread happened to sweep).  Verbs posted after
        ``upto_id`` stay in flight — a transfer waits only on the ids it
        depends on."""
        net = self.sim.net
        net.fences += 1
        if self.sim.tracer is not None:
            self.sim.tracer.note_fence(th, upto_id)
        take = [v for v in self._pending.values() if v.cid <= upto_id]
        t = max((v.done_us for v in take), default=0.0)
        t = max(t, self._retired_before(upto_id))
        if t > th.t_us:
            th.t_us = t
        if not take:
            return t
        for v in take:
            del self._pending[v.cid]
            self._retire(v.cid, v.done_us)
            self._tid_maxdone.pop(v.tid, None)   # recomputed on next post
        net.fenced_verbs += len(take)
        net.wb_drains += 1
        if not self._pending:
            self._bw_tail.clear()
            self._bw_tail_rd.clear()
        return t

    def fence_all(self, th) -> float:
        """Fence the whole cid window ever posted (full barrier)."""
        return self.fence(th, self._max_cid)

    # Backward-compatible name for the PR-1 full drain.
    drain = fence_all

    # ---- epoch / thread lifecycle --------------------------------------
    def forget(self, tid: int) -> int:
        """A thread retired: drop its per-thread completion state (QP rings,
        pending-verb tracking).  The retired verbs' cost is not lost — their
        completion times move to the retired-cid record (cids are globally
        unique, so this cannot pollute a reused thread id; a *dependent*
        fence on those cids still waits) and their latest completion is a
        makespan floor.  A rescale that wants a fully clean slate ends the
        epoch via ``Sim.snapshot()``/``Sim.reset()`` after retiring."""
        if self.sim.tracer is not None:
            self.sim.tracer.note_forget(tid)
        mine = [v for v in self._pending.values() if v.tid == tid]
        for v in mine:
            self._retired_floor = max(self._retired_floor, v.done_us)
            self._retire(v.cid, v.done_us)
            del self._pending[v.cid]
        self._tid_maxdone.pop(tid, None)
        if not self._pending:
            self._bw_tail.clear()
            self._bw_tail_rd.clear()
        self.sim._forget_tid(tid)
        return len(mine)

    def dispose_server(self, dead: int, at_us: float) -> list[_Verb]:
        """Recovery quiesce: every pending verb touching ``dead`` (an async
        WRITE into it, a speculative READ out of it) can never complete —
        the RC connection died with the NIC.  Each such verb is *disposed*
        exactly once: removed from the pending window and retired at
        ``at_us``, the recovery barrier, so a dependent completion-id fence
        neither waits forever on a completion that will never arrive nor
        silently forgets the dependency (it waits until the recovery
        declared the verb dead — the moment its outcome became known).
        Verbs posted *by* threads of the dead server to surviving servers
        are NOT disposed here: their bytes were DMA'd before the crash, so
        ``forget(tid)`` retires them at their real completion times.

        Returns the disposed verbs (the RecoveryManager records their cids
        in its exactly-once ledger and routes the speculative READs through
        the ``spec_log`` invalidation discipline)."""
        victims = [v for v in self._pending.values() if v.dst == dead]
        for v in victims:
            del self._pending[v.cid]
            self._retire(v.cid, at_us)
            self._tid_maxdone.pop(v.tid, None)   # recomputed on next post
        self._bw_tail.pop(dead, None)
        self._bw_tail_rd.pop(dead, None)
        if not self._pending:
            self._bw_tail.clear()
            self._bw_tail_rd.clear()
        if self.sim.tracer is not None and victims:
            self.sim.tracer.note_orphans([v.cid for v in victims])
        return victims

    def end_epoch(self) -> None:
        """End an observation epoch (``Sim.snapshot()``/``Sim.reset()``):
        clear every per-thread tail — pending verbs, legacy per-destination
        wires, QP state, and the retired-thread floor — so reused thread ids
        in a later epoch (elastic rescale) start clean."""
        self._pending.clear()
        self._bw_tail.clear()
        self._bw_tail_rd.clear()
        self._retired.clear()
        self._retired_hi = (0, 0.0)
        self._retired_floor = 0.0
        self._tid_maxdone.clear()
        self.sim._clear_qp_state()


class Sim:
    """Virtual-time cluster: per-server stats, per-thread clocks (on Thread).

    ``qps_per_thread``/``ooo`` select the completion model (module
    docstring): the defaults reproduce the PR-1 plane exactly; ``ooo=True``
    enables per-verb out-of-order completions over ``qps_per_thread`` queue
    pairs per thread with shared-link congestion.
    """

    def __init__(self, n_servers: int, cores_per_server: int = 16,
                 cost: CostModel | None = None, qps_per_thread: int = 1,
                 ooo: bool = False):
        self.n = n_servers
        self.cores = cores_per_server
        self.cost = cost or CostModel()
        # Event tracer (``repro_torch.analysis.sanitizer.Sanitizer``), installed
        # by ``Cluster(sanitize=True)``.  None = off: the completion plane
        # emits nothing — observation only, byte-identical either way.
        self.tracer = None
        self.qps = max(1, int(qps_per_thread))
        self.ooo = bool(ooo)
        self.servers = [ServerStats() for _ in range(n_servers)]
        self.net = NetStats()
        self._cids = itertools.count(1)          # cluster-wide completion ids
        self._qp_rr: dict[int, int] = {}         # tid -> last QP index rung
        self._qp_tail: dict[tuple[int, int], float] = {}  # (tid,qp) -> engine
        self._qp_done: dict[tuple[int, int], float] = {}  # (tid,qp) -> last CQE
        self.wb = WritebackQueue(self)
        # straggler model: per-server compute slowdown (thermal throttling,
        # noisy neighbours, failing DIMMs...).  1.0 = healthy.
        self.slowdown = [1.0] * n_servers
        # Failure state.  ``failing`` = unresponsive but not yet declared:
        # verbs posted to it burn the degraded-mode retry ladder and raise;
        # ``failed`` = declared dead by the controller (recovery ran or is
        # running): verbs raise immediately.  ``degrade`` escalates to
        # ``mark_failing`` escalates to ``declare_failed``.
        self.failing: set[int] = set()
        self.failed: set[int] = set()
        # ``lost`` = machines whose *compute* is gone forever (the scheduler
        # and controller never place threads there again).  ``rehosted``
        # maps a lost server's partition index to the surviving server now
        # physically serving it (backup promotion): traffic to the index
        # keeps its addresses but lands on the backup's NIC/CPU.
        self.lost: set[int] = set()
        self.rehosted: dict[int, int] = {}

    def batch(self) -> IOBatch:
        return IOBatch(self)

    def degrade(self, server: int, factor: float) -> None:
        """Slow-but-alive straggler (verbs still complete).  A server that
        stops answering entirely escalates to ``mark_failing`` (verbs burn
        the retry ladder) and finally ``declare_failed`` (fail-over ran)."""
        self.slowdown[server] = factor

    # ---- failure / elasticity -----------------------------------------
    def mark_failing(self, server: int) -> None:
        """The server stopped responding (crash suspected, not declared):
        synchronous verbs to it now time out through the retry/backoff
        ladder; async posts still enqueue (the NIC accepts the WQE — the
        verb becomes an orphan the recovery quiesce disposes)."""
        if server in self.failed:
            return
        self.failing.add(server)

    def declare_failed(self, server: int) -> None:
        """Controller declared the failure: every subsequent verb to the
        server raises ``ServerLostError`` immediately (no retry ladder) —
        until ``rehost`` remaps the partition onto its promoted backup."""
        self.failing.discard(server)
        self.failed.add(server)
        self.lost.add(server)

    def rehost(self, dead: int, backup: int) -> None:
        """Backup promotion completed: the dead server's partition index is
        served by ``backup`` from now on — verbs to it succeed again, and
        their NIC/CPU occupancy is charged to the backup's stats (that is
        the promoted replica absorbing the dead server's traffic).  The
        dead machine's *compute* stays lost."""
        self.rehosted[dead] = backup
        self.failed.discard(dead)

    def _serve(self, server: int) -> int:
        """Physical server currently serving a partition index (follows
        rehost chains — a promoted backup may itself have died later)."""
        while server in self.rehosted:
            server = self.rehosted[server]
        return server

    def alive_servers(self) -> list[int]:
        return [s for s in range(self.n) if s not in self.lost]

    def check_reachable(self, th, server: int, sync: bool = True) -> None:
        """Reachability gate charged before a verb to ``server``.  Declared
        failures raise immediately.  For a failing-but-undeclared server, a
        *synchronous* verb burns the full retry ladder on the caller's
        clock before raising (that latency is how the caller — and through
        it the controller's probe loop — learns the peer is gone); an
        *async* post (``sync=False``) is accepted by the local NIC and
        raises nothing — the verb simply never completes and is disposed
        as an orphan by the recovery quiesce."""
        if not (self.failed or self.failing):
            return
        if server in self.failed:
            raise ServerLostError(server, "declared failed; verb rejected")
        if sync and server in self.failing:
            pen = self.cost.retry_penalty_us()
            th.t_us += pen
            self.servers[th.server].cpu_busy_us += pen
            self.net.degraded_retries += self.cost.max_retries
            raise ServerLostError(
                server, f"unresponsive after {self.cost.max_retries} retries")

    def add_server(self) -> int:
        """Elastic grow: append a fresh server to the cluster (stats,
        slowdown, link accounting) and restripe the QP plane.  Returns the
        new server index.  The heap partition / cache / replica extension
        is the cluster layer's job (``Cluster.add_server``)."""
        s = self.n
        self.n += 1
        self.servers.append(ServerStats())
        self.slowdown.append(1.0)
        self.restripe()
        return s

    def restripe(self) -> None:
        """The server set changed (shrink or grow): every thread's RC
        connections are re-established against the new membership, so the
        per-thread QP rings/tails/CQ state are dropped.  Accumulated
        link/cpu occupancy is kept — it is history that already happened
        and still floors the makespan."""
        self._clear_qp_state()

    # ---- completion plane primitives -----------------------------------
    def next_cid(self) -> int:
        return next(self._cids)

    def select_qp(self, th) -> tuple[int, int]:
        """Round-robin QP pick for ``th``'s next doorbell; charges the QP
        switch cost when the ring differs from the thread's previous one."""
        tid = getattr(th, "tid", 0)
        prev = self._qp_rr.get(tid)
        qp = 0 if prev is None else (prev + 1) % self.qps
        self._qp_rr[tid] = qp
        if prev is not None and qp != prev:
            self.net.qp_switches += 1
            th.t_us += self.cost.qp_switch_us
        return (tid, qp)

    def qp_complete(self, th, server: int, nbytes: int,
                    n_verbs: int = 1) -> float:
        """Run one doorbell (``n_verbs`` coalesced WQEs, ``nbytes`` total)
        through the out-of-order completion model: pick the thread's next
        QP, serialize on its engine (bandwidth- or message-rate-limited),
        charge the shared link, add base latency, and floor by the QP's
        in-order CQ.  Returns the completion time; only the ``ooo=True``
        paths call this."""
        cost = self.cost
        key = self.select_qp(th)
        start = max(th.t_us, self._qp_tail.get(key, 0.0))
        occupancy = max(cost.xfer_us(nbytes), cost.qp_msg_us * n_verbs)
        engine_done = start + occupancy
        link_done = self.link_xfer(start, server, nbytes)
        self._qp_tail[key] = engine_done
        done = max(engine_done, link_done) + cost.one_sided_base_us
        done = max(done, self._qp_done.get(key, 0.0))        # CQ in order
        self._qp_done[key] = done
        return done

    def wire_done(self, start_us: float, server: int, nbytes: int) -> float:
        """Wire completion for a synchronous transfer starting at
        ``start_us``: the shared-link congestion model under ``ooo=True``,
        plain bandwidth otherwise — one dispatch point so the legacy and
        congested models cannot drift apart per call site."""
        if self.ooo:
            return self.link_xfer(start_us, server, nbytes)
        return start_us + self.cost.xfer_us(nbytes)

    def link_xfer(self, start_us: float, server: int, nbytes: int) -> float:
        """Charge an ``nbytes`` transfer to ``server``'s shared link: the
        transfer itself runs at link bandwidth from ``start_us`` (returned
        completion time), and the occupancy accumulates in
        ``ServerStats.link_busy_us`` — a saturated link is a *makespan*
        floor, exactly like a saturated CPU.  (A busy-until scalar would
        time-warp here: threads execute in program order with unsynchronized
        virtual clocks, so a thread ahead in time would spuriously delay a
        thread still in the link's idle past.)  Only the ``ooo=True``
        congestion model calls this; the caller guards."""
        us = self.cost.link_xfer_us(nbytes)
        self.servers[self._serve(server)].link_busy_us += us
        return start_us + us

    def _forget_tid(self, tid: int) -> None:
        self._qp_rr.pop(tid, None)
        for qp in range(self.qps):
            self._qp_tail.pop((tid, qp), None)
            self._qp_done.pop((tid, qp), None)

    def _clear_qp_state(self) -> None:
        self._qp_rr.clear()
        self._qp_tail.clear()
        self._qp_done.clear()

    # ---- thread-charged primitives -------------------------------------
    def compute(self, th, cycles: float) -> None:
        us = self.cost.cycles_us(cycles) * self.slowdown[th.server]
        th.t_us += us
        self.servers[th.server].cpu_busy_us += us

    def busy(self, th, us: float) -> None:
        us *= self.slowdown[th.server]
        th.t_us += us
        self.servers[th.server].cpu_busy_us += us

    def local_access(self, th, nbytes: int = 0) -> None:
        # In-memory object access; bandwidth term only for bulk payloads.
        us = self.cost.local_access_us + (nbytes / 2e4 if nbytes > 4096 else 0.0)
        th.t_us += us
        self.servers[th.server].cpu_busy_us += us

    def deref_check(self, th) -> None:
        self.busy(th, self.cost.deref_check_us)

    def rdma_read(self, th, src_server: int, nbytes: int) -> None:
        """One-sided READ: no CPU on the remote side."""
        self.check_reachable(th, src_server)
        self.next_cid()
        th.t_us = (self.wire_done(th.t_us, src_server, nbytes)
                   + self.cost.one_sided_base_us)
        self.net.one_sided_reads += 1
        self.net.bytes_moved += nbytes
        self.net.round_trips += 1
        self.servers[self._serve(src_server)].bytes_out += nbytes
        self.servers[th.server].bytes_in += nbytes

    def rdma_write(self, th, dst_server: int, nbytes: int) -> None:
        self.check_reachable(th, dst_server)
        self.next_cid()
        th.t_us = (self.wire_done(th.t_us, dst_server, nbytes)
                   + self.cost.one_sided_base_us)
        self.net.one_sided_writes += 1
        self.net.bytes_moved += nbytes
        self.net.round_trips += 1
        self.servers[self._serve(dst_server)].bytes_in += nbytes
        self.servers[th.server].bytes_out += nbytes

    def rdma_atomic(self, th, dst_server: int) -> None:
        self.check_reachable(th, dst_server)
        self.next_cid()
        th.t_us += self.cost.atomic_verb_us
        self.net.atomics += 1
        self.net.round_trips += 1

    def rpc(self, th, dst_server: int, req_bytes: int = 64,
            resp_bytes: int = 64, proc_us: float | None = None) -> None:
        """Two-sided request/response; remote CPU does ``proc_us`` of work."""
        self.check_reachable(th, dst_server)
        proc = self.cost.msg_proc_us if proc_us is None else proc_us
        us = (self.cost.two_sided_rtt_us + self.cost.xfer_us(req_bytes + resp_bytes)
              + proc)
        th.t_us += us
        self.net.two_sided_msgs += 2
        self.net.round_trips += 1
        self.net.bytes_moved += req_bytes + resp_bytes
        serve = self._serve(dst_server)
        self.servers[serve].cpu_busy_us += proc
        self.servers[serve].msgs += 1

    def ship_closure(self, th, dst_server: int, nbytes: int = 64) -> int:
        """Ship a delegated critical-section closure (captured arguments +
        code pointer, ~64 B) to a lock home as a doorbell-batched one-sided
        WRITE on the completion plane.  The poster pays only the issue
        cost — the closure's *completion* is observed when its convoy head
        polls (``convoy_complete``), and an orphaned closure (home died
        before running it) is disposed exactly once by the recovery
        quiesce like any other pending verb.  Returns the completion id."""
        return self.wb.post(th, dst_server, nbytes, kind="closure")

    def convoy_complete(self, th, home_server: int, new_convoy: bool,
                        one_sided: bool = True) -> None:
        """Completion accounting for one delegated critical section.  The
        *convoy head* (first waiter to arrive after the previous batch
        drained) pays one completion poll — a one-sided READ of the result
        slot under drust, the response half of the two-sided exchange under
        GAM/Grappa — and one round trip; joiners ride the head's poll
        (that is the N-waiters-one-round-trip amortization).  Latency is
        the caller's job (``sync.py`` owns the convoy serialization
        clock); this charges only the deterministic counters."""
        net = self.net
        net.delegated_sections += 1
        if new_convoy:
            net.convoy_completions += 1
            net.round_trips += 1
            if one_sided:
                net.one_sided_reads += 1
            else:
                net.two_sided_msgs += 1

    def async_msg(self, dst_server: int, nbytes: int = 64) -> None:
        """Off-critical-path message (e.g. async dealloc, lazy invalidation)."""
        if dst_server in self.failed:
            return                       # dropped on the floor: nobody listens
        self.net.async_msgs += 1
        self.net.bytes_moved += nbytes
        serve = self._serve(dst_server)
        self.servers[serve].cpu_busy_us += self.cost.msg_proc_us * 0.5
        self.servers[serve].msgs += 1

    # ---- aggregation ----------------------------------------------------
    def makespan_us(self, threads) -> float:
        """App completion time: slowest thread, a saturated server's CPU, or
        the last in-flight async write-back (pipelined cost is still cost)."""
        per_server_thread = [0.0] * self.n
        for t in threads:
            per_server_thread[t.server] = max(per_server_thread[t.server], t.t_us)
        span = self.wb.pending_completion_us
        for s in range(self.n):
            cpu = self.servers[s].cpu_busy_us / self.cores
            span = max(span, per_server_thread[s], cpu,
                       self.servers[s].link_busy_us)
        return span

    def snapshot(self) -> dict:
        """Stats snapshot; also ends the observation epoch — per-thread
        completion-plane state (write-back tails, QP rings) is cleared so a
        later epoch reusing thread ids (elastic rescale) starts clean.
        Compute ``makespan_us`` *before* snapshotting."""
        out = {
            "net": dataclasses.asdict(self.net),
            "servers": [dataclasses.asdict(s) for s in self.servers],
        }
        self.wb.end_epoch()
        return out

    def reset(self) -> None:
        """Zero every stat and clear the completion plane (fresh trace on
        the same cluster)."""
        self.net = NetStats()
        self.servers = [ServerStats() for _ in range(self.n)]
        self.wb.end_epoch()
        self.wb.posted = 0
