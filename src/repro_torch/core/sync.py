"""Distributed shared-state primitives (§4.1.2): DAtomic, DMutex, DRwLock.

Shared state cannot be type-checked by the ownership model, so DRust stores
the actual value on the global heap (only a Box pointer inside the Arc'd
struct) and serializes every operation at the value's home server.  The
paper's KV-store gap (§7.1, Fig. 5d) is exactly this single-home cliff —
every backend convoys on the lock home — so this module offers three
escalating designs:

* **Spin locks** (``DMutex(mode="spin")``, the original design): acquire is
  a home-server verb (DRust one-sided CAS, GAM two-sided message, Grappa
  delegation), the critical section runs *at the caller* — any data it
  touches on the home costs a remote verb per access while the lock is
  held, so lock hold time spans round trips and contention compounds.

* **Delegation / combining locks** (``DMutex(mode="delegate")``): a remote
  acquirer ships its critical-section *closure* to the lock home on the
  async completion plane (one posted WRITE, issue cost only) and the home
  runs the whole convoy back-to-back — data accesses are local there, and
  only the convoy *head* pays a completion round trip; joiners ride it.
  N contended waiters pay one amortized round trip instead of N serialized
  home round trips.  Per-backend transport: drust doorbell-batched closure
  ship + one-sided result poll, GAM two-sided send/response, Grappa native
  delegation (its normal access mode — delegation is free scalability
  there, at home-CPU cost).

* **Reader leases** (``DRwLock``): a read-mostly acquirer takes a
  home-granted lease — a region-lifetime *pinned immutable borrow*, the
  same freeze the deref coalescer exploits — and every subsequent read on
  that server is a pure local pointer chase: zero verbs until a writer
  revokes.  A write first revokes every outstanding lease (one async
  WRITE per leased server, fenced through the completion-id plane — the
  revocation fence), then mutates under an exclusive guard; the next read
  re-grants against the fresh value, so a reader can never observe
  pre-revocation state after the write (staleness safety is structural).

Contention is modeled through the home server's CPU/verb accounting plus a
per-primitive serialization clock (an acquire or delegated section cannot
start before the previous critical section on the same primitive has
released, in virtual time).  Recovery treats all three uniformly:
``core/fault.py`` calls ``on_server_failed`` on every registered primitive
— spin locks break when their holder died, delegated convoys drop their
references to closure cids the quiesce already disposed (exactly once),
and leases break when the leased cache or the lease table's home died.

This module is critical-section *plumbing over the guard surface*: data
access goes through ``ReadGuard``/``WriteGuard``/heap handles, never raw
``borrow()``/``deref()`` pairs (the CI guard lint covers this file).
"""

from __future__ import annotations

from typing import Any, Callable

from . import addr as A
from .protocol import ReadGuard, WriteGuard, detach_guard


def _raw(h) -> int:
    return A.clear_color(h.g) if hasattr(h, "g") else h.raw


class DAtomic:
    """Atomic cell; value lives at its home partition.

    * DRust uses **one-sided RDMA atomics** (FAA/CAS) — no remote CPU.
    * GAM's atomics ride its two-sided message path.
    * Grappa delegates, as always.
    """

    def __init__(self, cluster, th, init: Any = 0):
        self.cluster = cluster
        self.backend = cluster.backend
        self.h = self.backend.alloc(th, 8, init)
        self.home = A.server_of(_raw(self.h))

    def _verb(self, th) -> None:
        sim = self.cluster.sim
        if th.server == self.home:
            sim.local_access(th)
            return
        name = self.cluster.backend_name
        if name == "drust":
            sim.rdma_atomic(th, self.home)               # one-sided FAA/CAS
        elif name == "gam":
            sim.rpc(th, self.home, proc_us=sim.cost.msg_proc_us)
        else:
            sim.rpc(th, self.home, proc_us=sim.cost.delegation_proc_us)

    def _obj(self):
        return self.cluster.heap.get(_raw(self.h))

    def fetch_add(self, th, delta: Any = 1) -> Any:
        self._verb(th)
        obj = self._obj()
        old = obj.data
        obj.data = old + delta
        return old

    def load(self, th) -> Any:
        self._verb(th)
        return self._obj().data

    def store(self, th, value: Any) -> None:
        self._verb(th)
        self._obj().data = value

    def cas(self, th, expect: Any, new: Any) -> bool:
        self._verb(th)
        obj = self._obj()
        if obj.data == expect:
            obj.data = new
            return True
        return False


class DMutex:
    """Mutex whose metadata + owned object live on the global heap.

    ``mode="spin"`` runs critical sections at the caller (remote data
    accesses while holding the lock); ``mode="delegate"`` ships them to
    the lock home as combining-lock convoys.  ``server`` places the lock
    (and its protected object) on a specific partition — co-locate it
    with the data it guards.
    """

    def __init__(self, cluster, th, value: Any = None, size: int = 64,
                 mode: str = "spin", server: int | None = None):
        if mode not in ("spin", "delegate"):
            raise ValueError(f"unknown DMutex mode {mode!r}")
        self.cluster = cluster
        self.backend = cluster.backend
        self.mode = mode
        self.h = self.backend.alloc(th, size, value, server=server)
        self.home = A.server_of(_raw(self.h))
        self._release_t = 0.0          # serialization clock (virtual time)
        self._holder = None            # thread inside the critical section
        self._inflight: list[int] = []  # shipped-closure cids not yet retired
        self.acquisitions = 0
        self.contended = 0
        self.delegated = 0             # sections run at the home (delegate)
        self.convoys = 0               # convoy heads (completion round trips)
        self.broken = 0                # times recovery broke this lock
        # Recovery needs to find every live primitive to reconstruct
        # lock/lease state after a crash (see ``on_server_failed``).
        registry = getattr(cluster, "mutexes", None)
        if registry is not None:
            registry.append(self)

    # ---- verbs ----------------------------------------------------------
    def _lock_verb(self, th) -> None:
        sim = self.cluster.sim
        name = self.cluster.backend_name
        if th.server == self.home:
            sim.local_access(th)
        elif name == "drust":
            sim.rdma_atomic(th, self.home)               # CAS acquire
        elif name == "gam":
            sim.rpc(th, self.home, proc_us=sim.cost.msg_proc_us)
        else:
            sim.rpc(th, self.home, proc_us=sim.cost.delegation_proc_us)

    def _release_verb(self, th) -> None:
        """Release: DRust posts the unlock as a real async verb on the
        completion plane — fire-and-forget latency (issue cost only), but
        it draws a cid, runs ``check_reachable``, and is disposed exactly
        once by the recovery quiesce if the home dies with it in flight
        (a bare counter bump here was the satellite-2 bug: unlocking a
        crashed home silently "succeeded" and the cid ledger never saw
        in-flight unlocks).  GAM posts its release message without
        waiting for the ack; Grappa's delegated unlock is a blocking
        global-memory op."""
        sim = self.cluster.sim
        name = self.cluster.backend_name
        if th.server == self.home:
            sim.local_access(th)
        elif name == "drust":
            if self.cluster.batch_io:
                sim.wb.post(th, self.home, 8)
            else:
                sim.rdma_write(th, self.home, 8)
        elif name == "gam":
            sim.async_msg(self.home)
        else:
            self._lock_verb(th)

    def charge_section(self, th, reads: int = 0, read_bytes: int = 64,
                       compute_us: float = 0.0) -> None:
        """Charge a critical section's data accesses at the *caller* (spin
        mode): each of ``reads`` accesses to lock-home data costs a remote
        verb when the caller is remote — this is why spin-lock hold time
        spans round trips.  Explicit so the transactional kvstore path
        (``lock``/``unlock`` pairs) charges the same model ``with_lock``
        does."""
        sim = self.cluster.sim
        name = self.cluster.backend_name
        if compute_us:
            sim.busy(th, compute_us)
        if th.server == self.home:
            for _ in range(reads):
                sim.local_access(th)
        elif name == "drust":
            for _ in range(reads):
                sim.rdma_read(th, self.home, read_bytes)
        elif name == "gam":
            for _ in range(reads):
                sim.rpc(th, self.home, resp_bytes=read_bytes,
                        proc_us=sim.cost.msg_proc_us)
        else:
            for _ in range(reads):
                sim.rpc(th, self.home, resp_bytes=read_bytes,
                        proc_us=sim.cost.delegation_proc_us)

    # ---- recovery -------------------------------------------------------
    def break_lock(self, at_us: float) -> None:
        """Recovery lock-state reconstruction: the holder (or the home
        server's lock word) died.  Force-release so later acquirers
        serialize behind the recovery barrier instead of a dead holder —
        the critical section's un-flushed effects follow the epoch-revert
        contract (lost, reported, never resurrected)."""
        self._holder = None
        self._release_t = max(self._release_t, at_us)
        self.broken += 1

    def on_server_failed(self, dead: int, dead_tids, at_us: float):
        """Uniform recovery hook (``fault.py`` fail-over): returns
        ``(locks_broken, leases_broken)``.  Breaks the lock when its
        holder died; when the *home* died with shipped closures in
        flight, drops the convoy's cid references — the completion-plane
        quiesce already disposed those cids exactly once, the sections
        never ran (epoch-revert contract), and later acquirers serialize
        behind the recovery barrier against the restored lock word."""
        broken = 0
        h = self._holder
        if h is not None and (getattr(h, "tid", None) in dead_tids
                              or h.server == dead):
            self.break_lock(at_us)
            broken = 1
        if self.home == dead and self._inflight:
            self._inflight.clear()
            if not broken:
                self.break_lock(at_us)
                broken = 1
        return broken, 0

    # ---- critical sections ----------------------------------------------
    def lock(self, th) -> Any:
        """Explicit acquire (pairs with ``unlock``; sorted multi-lock
        acquisition in the transactional kvstore).  Returns the protected
        heap object.  Spin semantics regardless of mode — an explicit
        multi-lock hold cannot be shipped as one closure."""
        san = self.backend.sanitizer
        if san is not None:
            # Lockdep: record held->acquired order edges; an inverted
            # order (the sorted-bucket discipline broken) raises before
            # the deadlock can happen on real hardware.
            san.note_lock_acquire(th, self, name=f"DMutex@s{self.home}")
        self._lock_verb(th)
        self.acquisitions += 1
        if th.t_us < self._release_t:                    # wait for holder
            self.contended += 1
            th.t_us = self._release_t
        self._holder = th
        return self.cluster.heap.get(_raw(self.h))

    def unlock(self, th) -> None:
        """Explicit release.  If recovery broke the lock mid-section (the
        holder was declared dead), the release already happened during
        lock-state reconstruction — skip the verb."""
        if self._holder is not th:
            return
        self._holder = None
        self._release_t = max(self._release_t, th.t_us)  # section end
        self._release_verb(th)
        san = self.backend.sanitizer
        if san is not None:
            san.note_lock_release(th, self)

    def with_lock(self, th, fn: Callable[[Any], Any], reads: int = 0,
                  read_bytes: int = 64, compute_us: float = 0.0) -> Any:
        """Run one critical section; dispatches on the lock mode.

        ``reads``/``read_bytes``/``compute_us`` describe the section's
        data footprint on the lock home — remote verbs at the caller
        under spin, local accesses on the home's CPU under delegation
        (the entire point of shipping the closure to the data).  ``fn``
        must be the pure mutation (costs come from the knobs, or from
        ``fn`` charging the caller itself in legacy zero-knob sections).
        """
        if self.mode == "delegate" and th.server != self.home:
            return self._delegate(th, fn, reads, read_bytes, compute_us)
        obj = self.lock(th)
        try:
            self.charge_section(th, reads, read_bytes, compute_us)
            return fn(obj)
        finally:
            # A raising critical section still unlocks — otherwise every
            # later acquirer would serialize behind a lock nobody holds
            # (the unbalanced-release analogue of an unbalanced drop).
            self.unlock(th)

    def _delegate(self, th, fn: Callable[[Any], Any], reads: int,
                  read_bytes: int, compute_us: float) -> Any:
        """Combining-lock convoy: ship the closure, the home runs it.

        The closure arrives one-way-latency after the ship; the home
        executes arrivals back-to-back in arrival order (the convoy) —
        ``_release_t`` is the convoy tail.  A waiter arriving at a
        drained lock starts a new convoy and pays the completion round
        trip (result-slot poll); a waiter arriving while the convoy is
        busy joins it and rides the head's poll.  An unreachable home is
        discovered *before* the section runs: the shipped closure stays
        pending on the completion plane and the recovery quiesce disposes
        it exactly once (the section never executes — no partial state).
        """
        cluster = self.cluster
        sim, cost = cluster.sim, cluster.sim.cost
        name = cluster.backend_name
        home = self.home
        if name == "drust":
            cid = sim.ship_closure(th, home, 64)
            self._inflight.append(cid)
            one_way = cost.one_sided_base_us
        else:
            # Two-sided ship: the request half of a SEND/RECV exchange,
            # posted without waiting (issue cost only); the response half
            # is the convoy head's completion below.
            sim.check_reachable(th, home, sync=False)
            th.t_us += cost.wb_issue_us
            sim.net.two_sided_msgs += 1
            sim.net.closure_ships += 1
            sim.net.bytes_moved += 64
            sim.servers[sim._serve(home)].msgs += 1
            one_way = cost.two_sided_rtt_us / 2
        # An unresponsive-but-undeclared home surfaces here, on the
        # caller's retry ladder — before the section runs.
        sim.check_reachable(th, home)
        arrive = th.t_us + one_way
        new_convoy = arrive >= self._release_t
        start = max(arrive, self._release_t)
        proc = cost.msg_proc_us if name == "gam" else cost.delegation_proc_us
        exec_us = (proc + reads * cost.local_access_us + compute_us)
        exec_us *= sim.slowdown[sim._serve(home)]
        sim.servers[sim._serve(home)].cpu_busy_us += exec_us
        end = start + exec_us
        self._release_t = end
        self.acquisitions += 1
        self.delegated += 1
        if new_convoy:
            self.convoys += 1
        else:
            self.contended += 1
        result = fn(self.cluster.heap.get(_raw(self.h)))
        sim.convoy_complete(th, home, new_convoy,
                            one_sided=(name == "drust"))
        th.t_us = max(th.t_us, end + one_way)
        if name == "drust":
            self._inflight.clear()       # convoy drained: ships completed
        return result


class _LeaseRead:
    """``with rw.read(th) as v:`` — scoped *view* of a leased value.  The
    underlying lease persists past the scope (revocation is the writer's
    job); the scope only bounds the borrow-style access idiom."""

    __slots__ = ("rw", "th", "_value")

    def __init__(self, rw: "DRwLock", th):
        self.rw, self.th = rw, th

    def __enter__(self):
        self._value = self.rw.get(self.th)
        return self._value

    def __exit__(self, *exc):
        self._value = None
        return False


class DRwLock:
    """Read-mostly shared value with home-granted reader leases.

    The first read from a server takes a lease: a *pinned immutable
    borrow* (``ReadGuard(pin=True)``) — the same region-lifetime freeze
    the deref coalescer exploits — paying the one cold fetch.  Every
    subsequent read on that server is a local pointer chase: zero verbs.
    A write revokes all outstanding leases first (async WRITE per leased
    server + a completion-id fence — the revocation fence), then mutates
    under an exclusive ``WriteGuard``; readers re-grant afterwards and can
    never observe pre-revocation state (the guard cannot be entered while
    any lease's borrow is live, and the mutate happens only after every
    lease closed).  Recovery breaks leases exactly like locks
    (``on_server_failed``)."""

    def __init__(self, cluster, th, value: Any = None, size: int = 64,
                 server: int | None = None):
        self.cluster = cluster
        self.backend = cluster.backend
        self.h = self.backend.alloc(th, size, value, server=server)
        self._leases: dict[int, ReadGuard] = {}   # server -> held pin guard
        self._release_t = 0.0          # writer serialization clock
        self.lease_grants = 0
        self.lease_revokes = 0
        self.writes = 0
        self.broken = 0                # recovery broke the lease table
        self.broken_leases = 0         # individual leases recovery broke
        registry = getattr(cluster, "mutexes", None)
        if registry is not None:
            registry.append(self)

    @property
    def home(self) -> int:
        """Computed per access: a remote writer's ``WriteGuard`` *moves*
        the value under the ownership backend, so the home follows the
        handle instead of being cached at construction."""
        return A.server_of(_raw(self.h))

    # ---- leases ---------------------------------------------------------
    def _grant(self, th) -> ReadGuard:
        """Grant (or find) this server's lease.  The grant itself pays the
        cold read — one round trip for a remote home — and pins the copy;
        a granted server's reads are free until a writer revokes."""
        g = self._leases.get(th.server)
        if g is not None:
            return g
        if th.t_us < self._release_t:  # a write is mid-flight: wait it out
            th.t_us = self._release_t
        # A lease outlives lexical scope by design: the pinned guard stays
        # open until a writer revokes it, so no `with` is possible here.
        # Recovery (`on_server_failed`) and `_revoke` are the release paths.
        g = ReadGuard(self.backend, th, self.h, pin=True)  # lint: allow(guard-no-with)
        g.__enter__()  # lint: allow(guard-no-with)
        detach_guard(g)     # lease lifetime ends at revocation, not scope
        self._leases[th.server] = g
        self.lease_grants += 1
        self.cluster.sim.net.lease_grants += 1
        return g

    def acquire_lease(self, th) -> None:
        """Take this server's lease eagerly (the ``region(lease=...)``
        hint): pay the grant up front, before the read-heavy section."""
        self._grant(th)

    def get(self, th) -> Any:
        """Read the value.  Leased: DRust-check + local chase, zero verbs.
        Unleased: the grant's cold fetch."""
        sim = self.cluster.sim
        g = self._leases.get(th.server)
        if g is None:
            return self._grant(th).value
        sim.deref_check(th)
        sim.local_access(th)
        return g.value

    def read(self, th) -> _LeaseRead:
        """``with rw.read(th) as v:`` — scoped leased read."""
        return _LeaseRead(self, th)

    # ---- writes ---------------------------------------------------------
    def _revoke(self, th) -> int:
        """Revoke every outstanding lease before a write: close the pinned
        borrows, notify each leased server (async WRITE under drust, RPC
        under the message backends), and fence the notifications through
        the completion-id plane — the mutate below must not start until
        every reader's freeze is provably broken."""
        if not self._leases:
            return 0
        san = self.backend.sanitizer
        if san is not None:
            san.note_lease_revoke(th, self.h)
        cluster = self.cluster
        sim, net = cluster.sim, cluster.sim.net
        name = cluster.backend_name
        cids: list[int] = []
        n = 0
        for s in sorted(self._leases):
            g = self._leases.pop(s)
            g.close()
            n += 1
            if s == th.server:
                continue               # local lease-table entry: no verb
            if name == "drust":
                cids.append(sim.wb.post(th, s, 8, kind="revoke"))
            elif name == "gam":
                sim.rpc(th, s, proc_us=sim.cost.msg_proc_us)
            else:
                sim.rpc(th, s, proc_us=sim.cost.delegation_proc_us)
        if cids:
            sim.wb.fence(th, max(cids))          # the revocation fence
            net.round_trips += 1                 # completion poll
        self.lease_revokes += n
        net.lease_revokes += n
        return n

    def write(self, th, data: Any) -> None:
        """Replace the value: revoke leases, fence, mutate exclusively."""
        self.update(th, lambda _v: data)

    def update(self, th, fn: Callable[[Any], Any]) -> Any:
        self._revoke(th)
        if th.t_us < self._release_t:            # serialize vs prior writer
            th.t_us = self._release_t
        with WriteGuard(self.backend, th, self.h) as w:
            result = w.update(fn)
        self._release_t = max(self._release_t, th.t_us)
        self.writes += 1
        return result

    # ---- recovery -------------------------------------------------------
    def on_server_failed(self, dead: int, dead_tids, at_us: float):
        """Uniform recovery hook: break the dead server's lease (its cache
        died) and, when the *home* died, the whole lease table (the grant
        records died with it — conservative, like breaking a lock).
        Guards granted by dead threads are abandoned (fail-over already
        force-released their borrows); survivors' guards close normally
        (a drust drop is local-only, safe even when the home is gone).
        Returns ``(locks_broken, leases_broken)``."""
        home_dead = self.home == dead
        broken = 0
        for s in list(self._leases):
            if not (home_dead or s == dead):
                continue
            g = self._leases.pop(s)
            if s == dead or getattr(g.th, "tid", None) in dead_tids:
                g._abandon()
            else:
                g.close()
            broken += 1
        self.broken_leases += broken
        if home_dead:
            self.broken += 1
            self._release_t = max(self._release_t, at_us)
        return 0, broken
