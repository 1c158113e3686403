"""Fault tolerance (§4.2.3): replicated heap + crash-consistent fail-over.

Replication contract (the epoch-flush staleness contract)
---------------------------------------------------------
Each server's heap partition has a backup on another server at the same
virtual addresses.  Threads are *not* replicated.  A mutable borrow batches
its modifications; the write-back to the backup is delayed until the object
becomes visible to other servers — at **ownership transfer** and at explicit
epoch boundaries (``flush_epoch``, how the JAX training loop uses this: one
flush per train step).  The contract cuts both ways:

* anything flushed before the crash is restored **exactly** at its original
  virtual address (colored pointers into it stay valid);
* anything dirty-but-unflushed at crash time is **lost** — the restored
  object reverts to its last flushed epoch.  Recovery *reports* every such
  loss (``NetStats.lost_writes``, ``RecoveryReport.lost_writes``) and makes
  the stale pre-crash bytes unreachable (cache quarantine below); it never
  silently resurrects them as if they had committed.

An ``int8``-quantized partition checkpoint (``checkpoint_epoch``) is the
coarse second line of defence: objects that never reached the replica map
(allocated and used purely locally) restore from the checkpoint — lossy for
float payloads, exact for everything else.

Fail-over pipeline (``RecoveryManager``)
----------------------------------------
Recovery runs in three phases, each made *exact* by ownership state — the
borrow ledger tells the runtime precisely which objects can be mid-mutation
at crash time, which is the paper's argument for language-guided DSM applied
to resilience:

1. **quiesce** — every in-flight completion id touching the dead server is
   disposed exactly once: pending async WRITEs into it and speculative READ
   doorbells out of it retire at the recovery barrier
   (``WritebackQueue.dispose_server``); speculative cids route through the
   ``spec_log`` exactly-once discipline (``invalidated`` disposition, cache
   entries killed); staged channel sends from dead senders or to dead
   receivers drop; dead threads' verbs *to survivors* were DMA'd before the
   crash, so ``forget(tid)`` retires them at their real completion times.
   A recovery-private ledger asserts no cid is ever disposed twice.
2. **re-home** — the dead partition is restored from the promoted backup
   (``Replicator.promote``), falling back to the int8 checkpoint, at the
   original virtual addresses.  Guard-aware: open ``ReadGuard``s on
   surviving servers keep serving their frozen snapshots (cache entries go
   *suspect*: pinned copies serve existing holders, new lookups miss); an
   open ``WriteGuard`` on a dead-home box is **broken** — it surfaces a
   structured ``ServerLostError`` and releases the borrow without a
   write-back; borrows held by dead threads are force-released through the
   per-tid borrow ledger; ``DMutex`` holders that died are broken with
   lock-state reconstruction (later acquirers serialize behind the recovery
   barrier, not a dead holder).  Boxes with neither replica nor checkpoint
   are marked ``lost`` and raise ``ServerLostError`` on use.
3. **restripe** — ``Sim.rehost`` remaps the dead partition index onto the
   promoted backup (traffic keeps its addresses, lands on the backup's
   NIC/CPU), the QP plane restripes for the new membership, and survivors
   pay one control round trip each for RC re-establishment.  The same
   machinery handles elastic *grow* (``Cluster.add_server``).

Recovery cost is dominated by streaming the restored partition image
(``xfer_us(restored bytes)``), so the makespan scales with the dead
server's working set — not with cluster size (the SLO the recovery
benchmark gates).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from . import addr as A
from .heap import Obj
from .net import ServerLostError                      # noqa: F401 — re-export
from .ownership import _clone

try:
    import numpy as _np
except Exception:      # pragma: no cover
    _np = None


def _chain(prev, mine):
    """Compose runtime hooks: the previously installed hook still fires."""
    def hook(raw: int) -> None:
        prev(raw)
        mine(raw)
    return hook


def _chain2(prev, mine):
    """Two-argument variant of ``_chain`` (the ``on_move`` hook)."""
    def hook(old: int, new: int) -> None:
        prev(old, new)
        mine(old, new)
    return hook


def _quantize(data: Any) -> tuple:
    """Int8 checkpoint encoding: float ndarrays store (int8, scale); every
    other payload snapshots exactly (ints, bytes, pointer tables...)."""
    if _np is not None and isinstance(data, _np.ndarray) and data.dtype.kind == "f":
        amax = float(_np.max(_np.abs(data))) if data.size else 0.0
        scale = amax / 127.0
        if scale == 0.0:
            return ("q8", _np.zeros(data.shape, _np.int8), 0.0, str(data.dtype))
        q = _np.clip(_np.round(data / scale), -127, 127).astype(_np.int8)
        return ("q8", q, scale, str(data.dtype))
    return ("raw", _clone(data))


def _dequantize(snap: tuple) -> Any:
    if snap[0] == "q8":
        _, q, scale, dtype = snap
        return (q.astype(dtype) * scale).astype(dtype)
    return _clone(snap[1])


class Replicator:
    def __init__(self, cluster):
        self.cluster = cluster
        rt = cluster.drust
        self.rt = rt
        if getattr(rt, "_replicator", None) is not None:
            raise RuntimeError(
                "a Replicator is already attached to this runtime: a second "
                "one would double-charge replication traffic and race the "
                "first on the replica maps")
        rt._replicator = self
        n = cluster.sim.n
        self.backup_of = {s: (s + 1) % n for s in range(n)}
        # backup stores: primary server -> {raw addr -> (snapshot, size)}.
        # The size is captured at flush time (not recomputed at promote —
        # a recompute drifts for payloads without an intrinsic byte size).
        self.replicas: dict[int, dict[int, tuple[Any, int]]] = \
            {s: {} for s in range(n)}
        # int8 partition checkpoints: server -> {raw -> (encoded, size)}
        self.checkpoints: dict[int, dict[int, tuple[tuple, int]]] = {}
        self.pending: set[int] = set()          # dirty raw addrs, not yet flushed
        self.failed: set[int] = set()
        self.flushes = 0
        self.bytes_replicated = 0
        # Chain — never clobber — hooks installed before us: the runtime's
        # FT hooks are a shared notification bus, not this object's property.
        rt.on_write_visible = _chain(rt.on_write_visible, self._on_write)
        rt.on_alloc = _chain(rt.on_alloc, self._on_alloc)
        rt.on_free = _chain(rt.on_free, self._on_free)
        rt.on_transfer = _chain(rt.on_transfer, self._on_transfer)
        rt.on_move = _chain2(rt.on_move, self._on_move)

    # -- hooks ---------------------------------------------------------------
    def _on_alloc(self, raw: int) -> None:
        self.pending.add(raw)

    def _on_write(self, raw: int) -> None:
        # Batched: mark dirty; actual write-back deferred to the epoch edge.
        self.pending.add(raw)

    def _on_free(self, raw: int) -> None:
        self.pending.discard(raw)
        self.replicas[A.server_of(raw)].pop(raw, None)
        ckpt = self.checkpoints.get(A.server_of(raw))
        if ckpt is not None:
            ckpt.pop(raw, None)

    def _on_transfer(self, raw: int) -> None:
        self.flush_addr(raw)

    def _on_move(self, old: int, new: int) -> None:
        """The heap relocated an object (remote mutable deref / color
        overflow): FT state keyed by the old address must follow it, or a
        later crash of the OLD home would restore a stale replica at a
        freed — possibly reused — address.  The replica snapshot re-keys
        (it still holds the last flushed epoch, so crash recovery of the
        NEW home can revert to it); the new address is marked pending so
        the next flush re-replicates to the new home's backup.  The int8
        checkpoint entry does NOT follow — it is part of the old
        partition's image, and the bytes at the new address will be
        captured by the next ``checkpoint_epoch``."""
        self.pending.discard(old)
        self.pending.add(new)
        snap = self.replicas.get(A.server_of(old), {}).pop(old, None)
        if snap is not None:
            self.replicas.setdefault(A.server_of(new), {})[new] = snap
        ckpt = self.checkpoints.get(A.server_of(old))
        if ckpt is not None:
            ckpt.pop(old, None)

    # -- flushing --------------------------------------------------------------
    def flush_addr(self, raw: int) -> None:
        if raw not in self.pending or not self.rt.heap.contains(raw):
            self.pending.discard(raw)
            return
        primary = A.server_of(raw)
        obj = self.rt.heap.get(raw)
        self.replicas[primary][raw] = (_clone(obj.data), obj.size)
        backup = self.backup_of[primary]
        self.cluster.sim.async_msg(backup, obj.size)      # off critical path
        self.bytes_replicated += obj.size
        self.flushes += 1
        self.pending.discard(raw)

    def flush_epoch(self) -> int:
        """Flush every dirty object (train-step / program epoch boundary)."""
        n = 0
        for raw in list(self.pending):
            self.flush_addr(raw)
            n += 1
        return n

    def checkpoint_epoch(self) -> int:
        """Int8-quantized checkpoint of every live object, per partition —
        the coarse fallback for objects that never reached the replica map.
        Lossy for float ndarrays (quantized to int8 + scale), exact for
        everything else.  Returns the number of objects checkpointed."""
        n = 0
        for part in self.rt.heap.partitions:
            snap: dict[int, tuple[tuple, int]] = {}
            for raw, obj in part.objects.items():
                snap[raw] = (_quantize(obj.data), obj.size)
                n += 1
            self.checkpoints[part.server] = snap
        return n

    # -- failure handling --------------------------------------------------------
    def fail(self, server: int) -> None:
        """Crash ``server``: its primary partition contents are lost, and —
        critically — surviving servers' cached copies of its boxes may hold
        writes that died unflushed, so they are quarantined: unpinned
        copies invalidate immediately, pinned copies (open ``ReadGuard``s,
        frozen snapshots by contract) go *suspect* — they keep serving
        their holders but new lookups miss and they free at the last
        unpin.  Without the quarantine a post-crash read could silently
        resurrect a lost write from a warm cache."""
        self.failed.add(server)
        part = self.rt.heap.partitions[server]
        part.objects.clear()
        part.used = 0
        quarantine_dead_home(self.rt, self.cluster.sim, server)

    def promote(self, server: int) -> int:
        """Promote the backup of ``server``'s partition: restore every
        replicated object at its original virtual address (exact, stored
        size), fall back to the int8 checkpoint for objects the replica map
        never saw, then enlist a new backup (cost: re-replication of the
        partition)."""
        part = self.rt.heap.partitions[server]
        restored = 0
        seen: set[int] = set()
        for raw, (data, size) in self.replicas[server].items():
            part.objects[raw] = Obj(_clone(data), size)
            part.used += size
            seen.add(raw)
            restored += 1
        for raw, (snap, size) in self.checkpoints.get(server, {}).items():
            if raw in seen:
                continue                     # replica (exact, newer) wins
            part.objects[raw] = Obj(_dequantize(snap), size)
            part.used += size
            restored += 1
        # enlist a new backup server and re-replicate; if no live candidate
        # exists (single survivor) the old assignment stays — degraded
        sim = self.cluster.sim
        n = sim.n
        new_backup = (self.backup_of[server] + 1) % n
        for _ in range(n):
            if (new_backup != server and new_backup not in self.failed
                    and new_backup not in sim.lost):
                break
            new_backup = (new_backup + 1) % n
        else:
            new_backup = self.backup_of[server]
        self.backup_of[server] = new_backup
        for raw, (_, size) in self.replicas[server].items():
            self.cluster.sim.async_msg(new_backup, size)
        self.failed.discard(server)
        return restored

    def restored_bytes(self, server: int) -> int:
        """Bytes a promote of ``server`` streams (replica + checkpoint-only
        objects) — what the recovery makespan is charged for."""
        total = sum(size for _, size in self.replicas[server].values())
        for raw, (_, size) in self.checkpoints.get(server, {}).items():
            if raw not in self.replicas[server]:
                total += size
        return total

    def add_server(self, server: int) -> None:
        """Elastic grow: give the new server an empty replica map and a
        backup assignment (existing assignments are untouched)."""
        self.replicas.setdefault(server, {})
        sim = self.cluster.sim
        backup = (server + 1) % sim.n
        for _ in range(sim.n):
            if backup not in sim.lost and backup != server:
                break
            backup = (backup + 1) % sim.n
        self.backup_of[server] = backup

    def recover(self, server: int) -> int:
        """fail-over entry point used by the controller."""
        return self.promote(server)


def quarantine_dead_home(rt, sim, home: int) -> tuple[int, int]:
    """Scrub surviving caches of copies whose home is the failed server
    (see ``Replicator.fail``).  Speculative entries fire ``on_spec_drop``,
    so their prefetch cids get an ``invalidated`` disposition through the
    exactly-once ``spec_log`` discipline.  Returns cluster-wide
    ``(invalidated, suspected)`` counts and bumps
    ``NetStats.suspect_invalidations``."""
    invalidated = suspected = 0
    for s, H in enumerate(rt.caches):
        if s == home:
            continue                     # its own cache dies with it
        i, p = H.quarantine_home(home)
        invalidated += i
        suspected += p
    sim.net.suspect_invalidations += invalidated + suspected
    return invalidated, suspected


@dataclass
class RecoveryReport:
    """What one fail-over did — the structured receipt an application (or
    test oracle) audits instead of grepping logs."""
    server: int                    # the server that died
    backup: int                    # survivor now serving its partition index
    orphaned_cids: int             # pending verbs disposed at the barrier
    rehomed_boxes: int             # objects restored at original addresses
    lost_boxes: int                # objects with no replica/checkpoint
    lost_writes: int               # dirty-at-crash objects (epoch reverted)
    broken_guards: int             # open WriteGuards surfaced ServerLostError
    released_borrows: int          # dead threads' borrows force-released
    broken_locks: int              # DMutex holders broken
    dropped_channel_msgs: int      # staged sends orphaned by the crash
    dead_threads: int              # threads that died with the server
    restored_bytes: int            # partition image streamed from the backup
    makespan_us: float             # virtual time the fail-over took
    broken_leases: int = 0         # DRwLock reader leases broken


class RecoveryManager:
    """Drives the quiesce → re-home → restripe pipeline (module docstring).

    ``crash(server)`` models the *instant* of failure (data and threads die,
    peers start timing out); ``fail_over(server, th)`` is the controller's
    declared recovery; ``fail_and_recover`` runs both.  The manager keeps an
    exactly-once disposition ledger for every cid it orphans — a double
    disposition is a protocol bug and raises immediately."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.disposed: dict[int, str] = {}       # cid -> disposition
        self.reports: list[RecoveryReport] = []
        self._dead_threads: dict[int, list] = {}  # server -> threads that died
        self.quiescing = False   # True inside fail_over: placement migration
        #                          is suppressed while cids are being disposed

    # -- exactly-once ledger ---------------------------------------------
    def _dispose(self, cid: int, how: str) -> None:
        if cid in self.disposed:
            raise RuntimeError(
                f"cid {cid} disposed twice: {self.disposed[cid]!r} then {how!r}")
        self.disposed[cid] = how

    # -- phase 0: the instant of failure ---------------------------------
    def crash(self, server: int) -> list:
        """The machine dies: partition contents are gone, its threads stop
        mid-quantum, peers' verbs to it start burning the retry ladder
        (``failing``, not yet declared).  Surviving caches are quarantined
        so stale copies of its boxes cannot serve lost writes.  Returns the
        threads that died (their verbs are settled by ``fail_over``)."""
        cl = self.cluster
        sim = cl.sim
        sim.mark_failing(server)
        if cl.replicator is not None:
            cl.replicator.fail(server)           # clears partition + quarantine
        else:
            part = cl.heap.partitions[server]
            part.objects.clear()
            part.used = 0
            quarantine_dead_home(cl.drust, sim, server)
        cl.drust.caches[server].drop_all()       # its own cache died with it
        dead = []
        for th in cl.scheduler.threads:
            if not th.done and th.server == server:
                th.done = True
                dead.append(th)
                if cl.drust.coalescer is not None:
                    # registered derefs can never materialize — release the
                    # registration borrows without posting a doorbell
                    cl.drust.coalescer.discard(th)
                cl.controller.thread_table.pop(th.tid, None)
        self._dead_threads.setdefault(server, []).extend(dead)
        return dead

    # -- phases 1-3: declared fail-over ----------------------------------
    def fail_over(self, dead: int, th=None) -> RecoveryReport:
        """Quiesce, re-home, restripe (module docstring).  ``th`` is the
        surviving thread driving recovery (the controller daemon's); its
        clock pays the recovery makespan.  Defaults to the first live
        thread on a surviving server."""
        cl = self.cluster
        sim, net, cost = cl.sim, cl.sim.net, cl.sim.cost
        rt = cl.drust
        if th is None:
            th = next((t for t in cl.scheduler.threads
                       if not t.done and t.server != dead
                       and t.server not in sim.lost), None)
            if th is None:
                raise RuntimeError("no surviving thread to drive recovery")
        if dead not in sim.failed:
            sim.declare_failed(dead)
        t0 = th.t_us
        self.quiescing = True    # placement migration pauses until recovered

        # ---- 1. quiesce: dispose every orphaned cid exactly once --------
        victims = sim.wb.dispose_server(dead, th.t_us)
        for v in victims:
            # WRITE flavors keep their kind in the ledger: "orphaned-write"
            # (pipelined write-back, incl. the DMutex fire-and-forget
            # unlock), "orphaned-closure" (delegated critical section that
            # never ran), "orphaned-revoke" (lease revocation in flight).
            self._dispose(v.cid,
                          "orphaned-read" if v.is_read
                          else f"orphaned-{v.kind}")
            sim.busy(th, cost.hashmap_us)        # ledger walk, per orphan
            if v.is_read:
                # Speculative READ out of the dead server: route through the
                # spec_log exactly-once discipline.  The cache quarantine at
                # crash time may already have disposed the cid (its entries
                # were unpinned dead-home copies) — _dispose_spec is the
                # idempotent authority; the entries are gone either way.
                rt._dispose_spec(v.cid, "invalidated")
                for H in rt.caches:
                    H.invalidate_cid(v.cid)
        dead_ths = self._dead_threads.pop(dead, [])
        dead_tids = {t.tid for t in dead_ths}
        for t in dead_ths:
            # verbs dead threads posted to SURVIVORS were DMA'd pre-crash:
            # they retire at their real completion times, not the barrier
            sim.wb.forget(t.tid)
        dropped_msgs = 0
        for ch in cl.channels:
            dropped_msgs += ch.drop_for_server(dead)
        net.orphaned_cids += len(victims)

        # ---- 2. re-home: restore the partition, reconcile borrows -------
        rep = cl.replicator
        lost_writes = 0
        restored_bytes = 0
        if rep is not None:
            for raw in [r for r in rep.pending if A.server_of(r) == dead]:
                rep.pending.discard(raw)         # epoch revert: write is lost
                lost_writes += 1
            backup = rep.backup_of[dead]         # the replica holder, promoted
            if backup in sim.lost or backup == dead:
                backup = self._pick_backup(dead)
            restored_bytes = rep.restored_bytes(dead)
            restored = rep.promote(dead)
            # survivors whose backup WAS the dead server re-enlist a live
            # one and re-replicate their partitions (off the critical path);
            # with a single survivor there is no valid backup — it keeps the
            # dead assignment (degraded: unreplicated until the next grow)
            if len(sim.alive_servers()) > 1:
                for s, b in list(rep.backup_of.items()):
                    if s != dead and s not in sim.lost \
                            and (b == dead or b in sim.lost):
                        nb = self._pick_backup(s)
                        rep.backup_of[s] = nb
                        for _, (_, size) in rep.replicas.get(s, {}).items():
                            sim.async_msg(nb, size)
        else:
            restored = 0
            backup = self._pick_backup(dead)
        net.lost_writes += lost_writes
        if restored:
            # the promoted backup streams the partition image back up
            sim.busy(th, cost.alloc_us * restored)
            th.t_us += cost.one_sided_base_us + cost.xfer_us(restored_bytes)
            net.bytes_moved += restored_bytes
            sim.servers[backup].bytes_out += restored_bytes

        broken_guards = 0
        released = 0
        rehomed = 0
        lost_boxes = 0
        for raw, box in list(rt.owner_of.items()):
            if box is None or box.dropped:
                continue
            # borrows held by dead threads force-release (any home server)
            for tid in [t for t in box.ref_tids if t in dead_tids]:
                n = box.ref_tids.pop(tid)
                box.live_refs -= n
                released += n
            if box.live_mut and box.mut_tid in dead_tids:
                box.live_mut = False
                box.mut_tid = None
                released += 1
            if A.server_of(raw) != dead:
                continue
            if box.live_mut:
                # surviving holder's open WriteGuard on a dead-home box:
                # the write-back can never land — break the guard
                box.mut_broken = True
                broken_guards += 1
            if rt.heap.contains(raw):
                rehomed += 1
            else:
                box.lost = True                  # no replica, no checkpoint
                lost_boxes += 1
        net.rehomed_boxes += rehomed

        # Lock/lease-state reconstruction: every registered primitive
        # (DMutex spin *and* delegate convoys, DRwLock reader leases)
        # reconciles itself against the dead server — break locks whose
        # holder died, drop references to closure cids the quiesce above
        # already disposed, and break leases whose cache (or whose lease
        # table, when the home died) is gone.  NOTE: this runs AFTER the
        # borrow force-release loop, so a lease guard whose granting
        # thread died must be abandoned, not closed (the borrow count was
        # already settled there).
        broken_locks = 0
        broken_leases = 0
        for m in getattr(cl, "mutexes", []):
            locks, leases = m.on_server_failed(dead, dead_tids, th.t_us)
            broken_locks += locks
            broken_leases += leases
        net.broken_locks += broken_locks

        # ---- 3. restripe: new membership on the completion plane --------
        sim.rehost(dead, backup)
        sim.restripe()
        # RC re-establishment: one 16 B handshake per survivor, issued
        # back-to-back and completing in PARALLEL (one doorbell batch, the
        # multi-QP plane) — the driver waits one round trip plus the issue
        # costs, not n sequential round trips, so the restripe phase stays
        # flat in cluster size (the recovery SLO the benchmark gates)
        peers = [s for s in sim.alive_servers() if s != th.server]
        if peers:
            batch = sim.batch()
            for s in peers:
                batch.add_read(s, 16)
            batch.commit(th)

        # Sanitizer reconciliation: the dead threads' guards and locks were
        # force-released/abandoned by the phases above — settle their
        # accounting so the borrow-balance checks still hold for survivors.
        san = cl.backend.sanitizer
        if san is not None:
            san.on_failover(dead_tids)

        makespan = th.t_us - t0
        net.recovery_makespan_us = makespan
        report = RecoveryReport(
            server=dead, backup=backup, orphaned_cids=len(victims),
            rehomed_boxes=rehomed, lost_boxes=lost_boxes,
            lost_writes=lost_writes, broken_guards=broken_guards,
            released_borrows=released, broken_locks=broken_locks,
            dropped_channel_msgs=dropped_msgs, dead_threads=len(dead_ths),
            restored_bytes=restored_bytes, makespan_us=makespan,
            broken_leases=broken_leases)
        self.reports.append(report)
        self.quiescing = False
        return report

    def fail_and_recover(self, server: int, th=None) -> RecoveryReport:
        """Crash + immediate declared fail-over (the common test driver;
        production-shaped callers go through the controller's probe loop)."""
        self.crash(server)
        return self.fail_over(server, th)

    # -- helpers ----------------------------------------------------------
    def _pick_backup(self, dead: int) -> int:
        sim = self.cluster.sim
        b = (dead + 1) % sim.n
        for _ in range(sim.n):
            if b not in sim.lost and b != dead:
                return b
            b = (b + 1) % sim.n
        return (dead + 1) % sim.n        # no live candidate: degraded
