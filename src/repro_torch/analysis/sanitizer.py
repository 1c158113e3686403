"""Runtime borrow/cid sanitizer — ``Cluster(sanitize=True)``.

A TSan-style checker for the DSM runtime.  It installs as
``backend.sanitizer`` (mirroring the placement tracker) and hooks guard
enter/exit, lock acquisition, lease grant/revoke, ownership transfer,
speculative-cid disposition, and the completion plane's verb stream.

Checks enforced (violations raise :class:`SanitizerError` carrying the
tail of the event trace that led to them):

* **Balanced borrows** — every guard a thread opens is closed by the time
  the thread retires or migrates; ``fail_over`` reconciles the dead
  server's threads (their guards were force-released by recovery, not
  leaked).  Reader leases are *detached* from this accounting: they
  outlive scopes by design and are released by revocation or recovery.
* **Tombstoned payloads** — a ``ReadGuard``'s list/dict payload is served
  as an equal snapshot; using the snapshot after the guard closed raises,
  and a snapshot that was *mutated* under an immutable borrow is reported
  at close.  ``WriteGuard`` payloads are never wrapped (in-place mutation
  must land).
* **Exactly-once speculative-cid disposition** — every cid recorded by
  ``DrustRuntime.prefetch`` is disposed exactly once (``fenced`` /
  ``invalidated`` / ``orphaned-*``), cross-checked against ``spec_log``;
  a disposition for a cid that was never created, or a created cid left
  undisposed with no live owner still referencing it, is an error.
* **Lock acquisition order** — a lockdep-style held→acquired edge graph;
  a cycle (the transactional kvstore's sorted-bucket discipline broken)
  raises before the deadlock can happen.

The sanitizer is **observation only**: it never charges the cost model,
posts no verbs, and never mutates protocol state — a sanitized run's
counters and digests are byte-identical to the same run without it.

The recorded event trace doubles as the input to the coherence race
certifier (``analysis/races.py`` of the JAX package; not yet carried
over to this package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

# Event kinds consumed by the race certifier (races.py); the rest are
# provenance for error reports and debugging.
OPEN_KINDS = {"read_open", "pin_open", "write_open"}
CLOSE_KINDS = {"read_close", "pin_close", "write_close"}


@dataclass
class Event:
    """One sanitizer observation.  ``key`` identifies the synchronization
    object: ``id()`` of the box's placement root (drust: the TBox tie
    root, stable across write-moves) or of the handle itself (baselines),
    or of the lock/rwlock primitive.  ``epoch`` is the box version the
    access observed (bumped at every ``write_close``)."""

    seq: int
    kind: str
    tid: int
    key: int = 0
    epoch: int = 0
    t_us: float = 0.0
    src: int | None = None       # spawn parent / join child / migrate src
    detail: str = ""


class SanitizerError(RuntimeError):
    """An ownership-discipline violation, with event provenance."""

    def __init__(self, message: str, events: list[Event] | None = None):
        self.events = list(events or [])
        if self.events:
            tail = "\n".join(
                f"  #{e.seq} {e.kind} tid={e.tid} key={e.key:#x} "
                f"epoch={e.epoch} t={e.t_us:.1f}us {e.detail}".rstrip()
                for e in self.events[-12:]
            )
            message = f"{message}\nrecent events:\n{tail}"
        super().__init__(message)


# --------------------------------------------------------------------------
#  Tombstoned payload snapshots
# --------------------------------------------------------------------------
class _Cell:
    """Shared closed/adopted flags for one snapshot."""

    __slots__ = ("closed", "adopted", "where")

    def __init__(self) -> None:
        self.closed = False
        self.adopted = False
        self.where = ""


def _check_cell(cell: _Cell) -> None:
    if cell.closed and not cell.adopted:
        raise SanitizerError(
            f"guard payload used after its guard closed ({cell.where}) — "
            f"copy inside the with block or re-open a guard"
        )


class _SnapList(list):
    """List snapshot: equal by content, poisoned at guard close."""

    _san_cell: _Cell

    def _chk(self):
        _check_cell(self._san_cell)

    def __getitem__(self, i):
        self._chk()
        return list.__getitem__(self, i)

    def __iter__(self):
        self._chk()
        return list.__iter__(self)

    def __len__(self):
        self._chk()
        return list.__len__(self)

    def __contains__(self, x):
        self._chk()
        return list.__contains__(self, x)

    def __eq__(self, other):
        self._chk()
        return list.__eq__(self, other)

    __hash__ = None  # type: ignore[assignment]  # lists are unhashable


class _SnapDict(dict):
    """Dict snapshot: equal by content, poisoned at guard close."""

    _san_cell: _Cell

    def _chk(self):
        _check_cell(self._san_cell)

    def __getitem__(self, k):
        self._chk()
        return dict.__getitem__(self, k)

    def get(self, k, default=None):
        self._chk()
        return dict.get(self, k, default)

    def __iter__(self):
        self._chk()
        return dict.__iter__(self)

    def __len__(self):
        self._chk()
        return dict.__len__(self)

    def __contains__(self, k):
        self._chk()
        return dict.__contains__(self, k)

    def items(self):
        self._chk()
        return dict.items(self)

    def keys(self):
        self._chk()
        return dict.keys(self)

    def values(self):
        self._chk()
        return dict.values(self)

    def __eq__(self, other):
        self._chk()
        return dict.__eq__(self, other)

    __hash__ = None  # type: ignore[assignment]


def _snapshot(value: Any, cell: _Cell) -> Any:
    """Shallow snapshot of list/dict payloads (anything else is served
    as-is: scalars are immutable, arrays/objects keep identity)."""
    if type(value) is list or isinstance(value, _SnapList):
        s = _SnapList(list.__iter__(value) if isinstance(value, list) else value)
        s._san_cell = cell
        return s
    if type(value) is dict or isinstance(value, _SnapDict):
        s = _SnapDict(dict.items(value) if isinstance(value, dict) else value)
        s._san_cell = cell
        return s
    return None


def _raw_equal(snap: Any, orig: Any) -> bool:
    """Compare bypassing the poison checks."""
    if isinstance(snap, _SnapList):
        return list(list.__iter__(snap)) == orig
    if isinstance(snap, _SnapDict):
        return dict(dict.items(snap)) == orig
    return True


# --------------------------------------------------------------------------
#  The sanitizer
# --------------------------------------------------------------------------
@dataclass
class _OpenGuard:
    key: int
    kind: str                     # read | pin | write
    event: Event
    handle: Any
    snapshot: Any = None          # _SnapList/_SnapDict or None
    original: Any = None          # the heap value the snapshot cloned
    cell: _Cell | None = None


class Sanitizer:
    """One per ``Cluster(sanitize=True)``; installed as
    ``backend.sanitizer`` and ``sim.tracer``."""

    #: the most recently constructed sanitizer — apps build their Cluster
    #: internally, so callers that want the trace of a run they triggered
    #: (the race-certification tests, ``REPRO_SANITIZE=1`` debugging)
    #: reach it here.
    last: "Sanitizer | None" = None

    def __init__(self, cluster=None) -> None:
        Sanitizer.last = self
        self.cluster = cluster
        self.events: list[Event] = []
        self._seq = 0
        # borrow accounting: tid -> {id(guard): _OpenGuard}
        self.open: dict[int, dict[int, _OpenGuard]] = {}
        self._detached: set[int] = set()
        # box versioning
        self.epoch: dict[int, int] = {}
        self._key_refs: dict[int, Any] = {}   # keep roots alive: ids stay unique
        # speculative-cid ledger
        self.spec_created: dict[int, Event] = {}
        self.spec_disposed: dict[int, str] = {}
        # lockdep
        self.held: dict[int, list[int]] = {}            # tid -> [lock keys]
        self.lock_edges: dict[int, set[int]] = {}       # held-key -> then-key
        self.lock_names: dict[int, str] = {}
        # lease release tracking for the certifier lives in the trace
        # test hook: force the next N read_open events to record a stale
        # epoch (simulates a replica served after its epoch bump — the
        # injected coherence bug the race certifier must catch).
        self.inject_stale_reads = 0

    # ---- trace ----------------------------------------------------------
    @property
    def trace(self) -> list[Event]:
        return self.events

    def _emit(self, kind: str, th=None, key: int = 0, epoch: int = 0,
              src: int | None = None, detail: str = "") -> Event:
        tid = getattr(th, "tid", th if isinstance(th, int) else -1)
        t_us = getattr(th, "t_us", 0.0)
        e = Event(self._seq, kind, tid, key, epoch, t_us, src, detail)
        self._seq += 1
        self.events.append(e)
        return e

    def _err(self, message: str) -> SanitizerError:
        return SanitizerError(message, self.events)

    # ---- keys -----------------------------------------------------------
    def key_of(self, h: Any) -> int:
        """Synchronization key for a handle: the placement root's identity
        (drust — a TBox child conflicts through its tie root, and DBox
        identity is stable across write-moves) or the handle's own."""
        backend = getattr(self.cluster, "backend", None)
        root = h
        pr = getattr(backend, "placement_root", None)
        if pr is not None and hasattr(h, "g"):
            try:
                root = pr(h)
            except Exception:
                root = h
        k = id(root)
        self._key_refs[k] = root
        return k

    # ---- guard hooks (called from core/protocol.py) ---------------------
    def on_read_enter(self, guard, value: Any, pin: bool = False) -> Any:
        key = self.key_of(guard.h)
        epoch = self.epoch.get(key, 0)
        if self.inject_stale_reads > 0 and epoch > 0 and not pin:
            self.inject_stale_reads -= 1
            epoch -= 1          # the bug: replica content from before the bump
        evt = self._emit("pin_open" if pin else "read_open", guard.th, key,
                         epoch=epoch)
        cell = _Cell()
        cell.where = f"read guard opened at event #{evt.seq}"
        snap = _snapshot(value, cell)
        og = _OpenGuard(key, "pin" if pin else "read", evt, guard.h,
                        snapshot=snap, original=value, cell=cell)
        self.open.setdefault(evt.tid, {})[id(guard)] = og
        return value if snap is None else snap

    def on_write_enter(self, guard) -> None:
        key = self.key_of(guard.h)
        evt = self._emit("write_open", guard.th, key,
                         epoch=self.epoch.get(key, 0))
        og = _OpenGuard(key, "write", evt, guard.h)
        self.open.setdefault(evt.tid, {})[id(guard)] = og

    def on_guard_close(self, guard, kind: str) -> None:
        tid = getattr(guard.th, "tid", -1)
        og = self.open.get(tid, {}).pop(id(guard), None)
        if og is None and id(guard) in self._detached:
            self._detached.discard(id(guard))
            key = self.key_of(guard.h)
            self._emit("lease_close", guard.th, key,
                       epoch=self.epoch.get(key, 0))
            return
        if og is None:
            raise self._err(
                f"{kind} guard closed that the sanitizer never saw open "
                f"(double close after abandon, or a guard from another run)")
        if og.kind == "write":
            new_epoch = self.epoch.get(og.key, 0) + 1
            self.epoch[og.key] = new_epoch
            self._emit("write_close", guard.th, og.key, epoch=new_epoch)
        else:
            self._emit(f"{og.kind}_close", guard.th, og.key,
                       epoch=self.epoch.get(og.key, 0))
            if og.cell is not None:
                og.cell.closed = True
                og.cell.where = (
                    f"guard opened at event #{og.event.seq}, "
                    f"closed at event #{self._seq - 1}")
            if og.snapshot is not None and not _raw_equal(og.snapshot,
                                                          og.original):
                raise self._err(
                    "payload mutated under an immutable read borrow — "
                    "writes require a write guard")

    def adopt(self, data: Any) -> Any:
        """A guard payload snapshot is being *stored* (``w.set(v)`` /
        ``w.update`` staging): hand the heap a plain equal copy so the
        stored value never carries a poisonable wrapper — storing a
        snapshot is publication, not use-after-close."""
        if isinstance(data, _SnapList):
            return list(list.__iter__(data))
        if isinstance(data, _SnapDict):
            return dict(dict.items(data))
        return data

    def on_guard_abandon(self, guard) -> None:
        """Recovery abandoned the guard: accounting settled by the
        fail-over ledger, not by a close — just drop the tracking."""
        tid = getattr(guard.th, "tid", -1)
        og = self.open.get(tid, {}).pop(id(guard), None)
        self._detached.discard(id(guard))
        if og is not None:
            self._emit("guard_abandon", guard.th, og.key)
            if og.cell is not None:
                og.cell.closed = True
                og.cell.where = "guard abandoned by recovery"

    def detach_guard(self, guard) -> None:
        """A reader lease's pinned guard deliberately outlives lexical
        scope and its granting thread; exempt it from borrow balance."""
        tid = getattr(guard.th, "tid", -1)
        og = self.open.get(tid, {}).pop(id(guard), None)
        self._detached.add(id(guard))
        key = og.key if og is not None else self.key_of(guard.h)
        self._emit("lease_grant", guard.th, key,
                   epoch=self.epoch.get(key, 0))

    # ---- thread lifecycle (called from core/runtime.py) -----------------
    def note_spawn(self, parent, child) -> None:
        self._emit("spawn", child, src=getattr(parent, "tid", None))

    def note_join(self, child, waiter) -> None:
        self._emit("join", waiter, src=getattr(child, "tid", None))

    def check_thread(self, th, where: str, detail: str = "") -> None:
        """Balanced-borrow checkpoint (retire / migrate)."""
        tid = getattr(th, "tid", -1)
        leaked = self.open.get(tid, {})
        if leaked:
            kinds = ", ".join(
                f"{og.kind} guard on key {og.key:#x} "
                f"(opened at event #{og.event.seq})"
                for og in leaked.values())
            raise self._err(
                f"thread {tid} {where}d with {len(leaked)} live guard(s): "
                f"{kinds}")
        self._emit(where, th, detail=detail)

    def on_failover(self, dead_tids) -> None:
        """Recovery force-released the dead threads' borrows; settle their
        accounting here so survivors still balance."""
        for tid in dead_tids:
            for og in self.open.pop(tid, {}).values():
                if og.cell is not None:
                    og.cell.closed = True
                    og.cell.where = "guard's thread died (fail_over)"
            self.held.pop(tid, None)     # broken locks: recovery released
        self._emit("failover", -1, detail=f"dead tids {sorted(dead_tids)}")

    # ---- ownership edges (called from core/ownership.py) ----------------
    def note_transfer(self, th, box, dst: int) -> None:
        key = self.key_of(box)
        self._emit("transfer", th, key, epoch=self.epoch.get(key, 0),
                   detail=f"-> server {dst}")

    def note_migrate_here(self, th, box) -> None:
        key = self.key_of(box)
        self._emit("migrate_here", th, key, epoch=self.epoch.get(key, 0))

    # ---- speculative cids (called from core/ownership.py) ---------------
    def note_spec(self, th, cid: int) -> None:
        self.spec_created[cid] = self._emit("spec_post", th, detail=f"cid {cid}")

    def note_spec_dispose(self, cid: int, how: str, fresh: bool) -> None:
        """``fresh`` is ``_dispose_spec``'s return: False means the cid was
        already disposed and this call was the idempotent no-op path."""
        if not fresh:
            return
        if cid not in self.spec_created:
            raise self._err(
                f"speculative cid {cid} disposed ({how}) but never created "
                f"by prefetch — phantom disposition")
        if cid in self.spec_disposed:
            raise self._err(
                f"speculative cid {cid} disposed twice "
                f"({self.spec_disposed[cid]}, then {how})")
        self.spec_disposed[cid] = how
        self._emit("spec_dispose", -1, detail=f"cid {cid}: {how}")

    def check_spec_ledger(self) -> None:
        """Exactly-once cross-check vs ``DrustRuntime.spec_log``: every
        created cid is disposed, or still pending with a live owner whose
        ``fetch_cid`` references it (a prefetch not yet used)."""
        rt = getattr(self.cluster, "drust", None)
        if rt is not None:
            log = rt.spec_log
            for cid in self.spec_disposed:
                if cid not in log:
                    raise self._err(
                        f"sanitizer saw cid {cid} disposed but spec_log "
                        f"has no record — ledgers diverged")
            for cid, how in log.items():
                if cid in self.spec_created and cid not in self.spec_disposed:
                    raise self._err(
                        f"spec_log disposed cid {cid} ({how}) without the "
                        f"sanitizer hook firing — unhooked disposition path")
        pending = set(self.spec_created) - set(self.spec_disposed)
        if not pending:
            return
        live = set()
        if rt is not None:
            for box in rt.owner_of.values():
                if box.fetch_cid:
                    live.add(box.fetch_cid)
        leaked = pending - live
        if leaked:
            raise self._err(
                f"speculative cid(s) {sorted(leaked)} neither disposed nor "
                f"referenced by any live owner — leaked prefetch")

    # ---- locks (called from core/sync.py) -------------------------------
    def note_lock_acquire(self, th, lock, name: str = "") -> None:
        key = id(lock)
        self._key_refs[key] = lock
        self.lock_names.setdefault(key, name or type(lock).__name__)
        tid = getattr(th, "tid", -1)
        held = self.held.setdefault(tid, [])
        for h in held:
            if h == key:
                raise self._err(
                    f"thread {tid} re-acquired {self.lock_names[key]} "
                    f"{key:#x} it already holds")
            self.lock_edges.setdefault(h, set()).add(key)
        # lockdep: adding h->key for every held h creates a deadlock iff a
        # path key ->* h already exists for some held h.
        for h in held:
            path = self._lock_path(key, h)
            if path:
                names = " -> ".join(
                    self.lock_names.get(k, hex(k)) for k in [h, *path])
                raise self._err(
                    f"lock acquisition order inverted (deadlock): thread "
                    f"{tid} holds {self.lock_names.get(h, hex(h))} and "
                    f"acquires {self.lock_names.get(key, hex(key))}, but the "
                    f"reverse order was also observed ({names}) — acquire "
                    f"in a global (sorted) order")
        held.append(key)
        self._emit("lock_acquire", th, key)

    def note_lock_release(self, th, lock) -> None:
        key = id(lock)
        tid = getattr(th, "tid", -1)
        held = self.held.get(tid, [])
        if key in held:
            held.remove(key)
        self._emit("lock_release", th, key)

    def _lock_path(self, start: int, goal: int) -> list[int] | None:
        """DFS: a path start ->* goal through recorded order edges."""
        stack: list[tuple[int, list[int]]] = [(start, [start])]
        seen = {start}
        while stack:
            node, path = stack.pop()
            if node == goal:
                return path
            for nxt in self.lock_edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # ---- leases (called from core/sync.py DRwLock) ----------------------
    def note_lease_revoke(self, th, rwlock_h) -> None:
        key = self.key_of(rwlock_h)
        self._emit("lease_revoke", th, key, epoch=self.epoch.get(key, 0))

    # ---- completion-plane tracer (installed as Sim.tracer) --------------
    def note_post(self, th, cid: int, dst: int, nbytes: int, kind: str,
                  is_read: bool = False) -> None:
        self._emit("verb_post", th,
                   detail=f"cid {cid} {'READ' if is_read else 'WRITE'} "
                          f"{kind} {nbytes}B -> s{dst}")

    def note_fence(self, th, upto: int) -> None:
        self._emit("fence", th, detail=f"upto cid {upto}")

    def note_forget(self, tid: int) -> None:
        self._emit("forget", tid)

    def note_orphans(self, cids) -> None:
        self._emit("orphan", -1, detail=f"cids {sorted(cids)}")

    # ---- end-of-run -----------------------------------------------------
    def final_check(self) -> None:
        """Quiescence checkpoint (``Cluster.makespan_us``): the spec-cid
        ledger must balance.  Open guards are legal here — the caller may
        measure mid-run — so borrow balance is only enforced at thread
        checkpoints."""
        self.check_spec_ledger()
