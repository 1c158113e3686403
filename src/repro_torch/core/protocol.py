"""The backend-generic protocol surface: ``ProtocolBackend`` + scoped guards.

The paper's thesis is that *exposing ownership semantics to the runtime* is
what makes DSM coherence cheap.  This module is where that exposure happens
at the API level:

* ``ProtocolBackend`` — the single ABC every protocol engine implements
  (``DrustRuntime``, ``GamBackend``, ``GrappaBackend``).  Verbs:
  ``alloc`` / ``read`` / ``write`` / ``update`` / ``transfer`` / ``drop`` /
  ``read_many`` / ``prefetch``.  Applications written against this surface
  (or against the guards below) are backend-generic — the drust-only
  special cases collapse into the ``supports_*`` capability flags.

* ``ReadGuard`` / ``WriteGuard`` — RAII scoped borrows.  ``with
  box.read(th) as v:`` *is* the borrow lifetime: entering takes the borrow
  and dereferences, the body sees the payload, exiting drops the borrow
  (and, for writes, performs the write-back).  Because the scope is
  lexical, the runtime is *told* the settle point instead of having to
  infer it, and an exception inside the body structurally releases the
  borrow — unbalanced-drop leaks are impossible by construction.

* ``Region`` — ``with cluster.region(th) as r:`` — a batching scope whose
  exit is a coalescer settle point: the thread's registered derefs flush
  as ``read_many`` doorbells and its staged channel sends ring, exactly
  the work touched inside the scope.  Entry accepts ``r.prefetch(boxes)``
  (speculative read doorbells) and ``r.pin(boxes)`` (region-lifetime
  immutable borrows that keep cache copies pinned) hints.

Cost discipline: the guards charge **exactly** what the legacy
``borrow()``/``deref()``/``drop_ref()`` call pairs charged — enter defers
every deref cost to first use (``.value`` / ``.set``), so the legacy verbs
reimplemented as thin shims *on top of* the guards stay byte-identical to
the PR-1/PR-4 golden traces.

Python has no borrow checker, so misuse is caught dynamically: a write
guard inside a read guard raises ``BorrowError`` on every backend (the
ownership backend enforces it through real borrows; the directory and
delegation backends through the guard layer's per-handle borrow counts),
and using a guard's payload accessor after exit raises ``BorrowError``.
"""

from __future__ import annotations

import abc
from typing import Any, Callable

from . import addr as A


class BorrowError(RuntimeError):
    """A program the Rust borrow checker would have rejected."""


_MISSING = object()          # sentinel: "not staged / not fetched yet"


def _bump_guard_stat(backend, key: str) -> None:
    """Count guard entries on the backend (``backend.guard_stats``).

    Lazy per-backend dict so every engine gets the counters without any
    subclass opt-in; a ``__slots__`` backend simply goes uncounted.  The
    counters are observability only (serve ``stats()``, debugging) — they
    are never charged to the cost model and never gated.
    """
    stats = getattr(backend, "guard_stats", None)
    if stats is None:
        try:
            stats = backend.guard_stats = {
                "read_guards": 0, "write_guards": 0, "regions": 0, "pins": 0}
        except AttributeError:               # pragma: no cover - __slots__
            return
    stats[key] = stats.get(key, 0) + 1


def _note_open(backend, tid: int, kind: str, delta: int) -> None:
    """Open-guard accounting: a gauge per guard kind in ``guard_stats``
    (``open_read_guards``/``open_write_guards``/``open_pins``/
    ``open_regions``) plus a per-thread count (``backend.open_by_tid``) so
    ``Scheduler.retire`` can warn on a thread leaving with live guards.
    Observability only — never charged, never gated."""
    stats = getattr(backend, "guard_stats", None)
    if stats is not None:
        k = "open_" + kind
        n = stats.get(k, 0) + delta
        stats[k] = n if n > 0 else 0
    m = getattr(backend, "open_by_tid", None)
    if m is None:
        try:
            m = backend.open_by_tid = {}
        except AttributeError:               # pragma: no cover - __slots__
            return
    n = m.get(tid, 0) + delta
    if n > 0:
        m[tid] = n
    else:
        m.pop(tid, None)


def detach_guard(g: "ReadGuard") -> None:
    """Exempt a deliberately scope-escaping guard (a reader lease's pinned
    copy — see ``core/sync.py``) from open-guard accounting: the lease is
    released by writer revocation or recovery, not by the granting
    thread's scope, so it must not count as a leak at retire."""
    g._detached = True
    _note_open(g.backend, getattr(g.th, "tid", -1),
               "pins" if g._pin else "read_guards", -1)
    san = g.backend.sanitizer
    if san is not None:
        san.detach_guard(g)


# --------------------------------------------------------------------------
#  Backend registry (capability lookup without string special-casing)
# --------------------------------------------------------------------------
_REGISTRY: dict[str, type] = {}


def register_backend(cls):
    """Class decorator: make ``cls`` discoverable by its ``name``."""
    _REGISTRY[cls.name] = cls
    return cls


def backend_class(name: str) -> type:
    """The ``ProtocolBackend`` subclass registered under ``name``."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r} "
                         f"(registered: {sorted(_REGISTRY)})") from None


def backend_caps(name: str) -> type:
    """Capability view of a backend (the class itself: ``supports_*`` are
    class attributes, so no instance is needed to consult them)."""
    return backend_class(name)


# --------------------------------------------------------------------------
#  The ABC
# --------------------------------------------------------------------------
class ProtocolBackend(abc.ABC):
    """One DSM protocol engine; every verb charges its own cost model.

    Subclasses override the ``_enter_*``/``_write_*`` guard hooks when the
    protocol has real borrow state (DRust); the defaults here implement
    guard semantics for cache/delegation protocols by tracking per-handle
    borrow counts in the guard layer itself, so borrow-misuse raises
    ``BorrowError`` uniformly across backends.
    """

    name: str = "?"
    # Capability flags — what the apps used to special-case on the backend
    # name string.  Ownership = borrow lifetimes are protocol input.
    supports_ownership = False
    supports_affinity = False      # tie_to / TBox groups
    supports_prefetch = False      # speculative fetch is staleness-safe
    supports_coalescing = False    # runtime deref coalescer can register
    # Access-locality tracker (``core/runtime.py`` PlacementTracker),
    # installed by ``Cluster(placement="auto")``.  None = placement off:
    # the guards skip telemetry entirely, so the default path stays
    # byte-identical to the static-placement golden traces.
    placement = None
    # Runtime borrow/cid sanitizer (``repro_torch.analysis.sanitizer``),
    # installed by ``Cluster(sanitize=True)``.  None = sanitize off: the
    # guards skip the hooks entirely — observation only, byte-identical
    # counters either way.
    sanitizer = None

    # ---- verbs ----------------------------------------------------------
    @abc.abstractmethod
    def alloc(self, th, size: int, data: Any = None, server: int | None = None,
              tie_to=None):
        """Allocate a global object; returns a handle."""

    @abc.abstractmethod
    def read(self, th, h) -> Any:
        """Whole-object immutable read (borrow + deref + drop)."""

    @abc.abstractmethod
    def write(self, th, h, data: Any) -> None:
        """Whole-object write (mutable borrow + deref_mut + drop)."""

    @abc.abstractmethod
    def read_many(self, th, handles) -> list:
        """Batched immutable read: cold misses coalesce per source server."""

    def update(self, th, h, fn: Callable[[Any], Any]) -> Any:
        """Read-modify-write through one write guard."""
        with WriteGuard(self, th, h) as w:
            return w.update(fn)

    def transfer(self, th, h, dst_server: int) -> None:
        """Ownership transfer.  Only meaningful where ownership exists —
        the default is a no-op (directory/delegation protocols have no
        owner to move; placement is fixed by the home node)."""
        return None

    @abc.abstractmethod
    def drop(self, th, h) -> None:
        """Drop the handle out of scope: dealloc + invalidation."""

    def free(self, th, h) -> None:
        """Legacy alias for ``drop``."""
        self.drop(th, h)

    def prefetch(self, th, handles) -> int:
        """Speculative fetch; only staleness-safe with ownership — the
        default posts nothing (apps run unmodified)."""
        return 0

    def locate(self, h) -> int:
        """Server currently hosting ``h``'s payload — the data-affinity
        placement target (``Scheduler.spawn_to`` resolves through this,
        never through the allocation-time home).  The default reads the
        handle's global address, which is exact for fixed-home protocols
        (GAM/Grappa never move data); ownership backends override to track
        write-moves and transfers."""
        return A.server_of(h.g if hasattr(h, "g") else h.raw)

    # ---- guard hooks (default: guard-layer borrow tracking) -------------
    def _enter_read(self, th, h):
        """Take the read borrow and deref; returns (release-token, value)."""
        if getattr(h, "live_mut", False):
            raise BorrowError(
                f"{self.name}: read guard while write guard alive")
        val = self.read(th, h)     # may raise: borrow only counted on success
        h.live_refs = getattr(h, "live_refs", 0) + 1
        return True, val

    def _exit_read(self, th, h, token) -> None:
        if token:
            h.live_refs -= 1

    def _enter_pin(self, th, h):
        """Region-lifetime pin: like a read borrow, but must hold a *real*
        borrow / pinned cache copy for the whole scope — never deferred to
        a coalescer (a registration can be flushed by a conflicting write,
        which would silently drop the pin's exclusion guarantee)."""
        return self._enter_read(th, h)

    def _enter_write(self, th, h):
        """Take the write borrow; returns the write token.  No deref cost
        is charged here — ``.value``/``.set`` charge lazily, so the legacy
        ``write``/``update`` shims cost exactly what they always did."""
        if getattr(h, "live_mut", False) or getattr(h, "live_refs", 0):
            raise BorrowError(
                f"{self.name}: write guard while other guards alive")
        h.live_mut = True
        return {"staged": _MISSING, "seen": _MISSING}

    def _write_value(self, th, h, token) -> Any:
        if token["staged"] is not _MISSING:
            return token["staged"]
        if token["seen"] is _MISSING:
            token["seen"] = self.read(th, h)      # charged like any read
        return token["seen"]

    def _write_set(self, th, h, token, data: Any) -> None:
        token["staged"] = data

    def _exit_write(self, th, h, token) -> None:
        h.live_mut = False
        if token["staged"] is not _MISSING:
            self.write(th, h, token["staged"])    # the write-back
        elif token["seen"] is not _MISSING:
            self.write(th, h, token["seen"])      # in-place mutation lands


# --------------------------------------------------------------------------
#  Scoped guards
# --------------------------------------------------------------------------
class ReadGuard:
    """``with h.read(th) as v:`` — enter = immutable borrow + deref,
    body = payload, exit = drop.  ``guard.value`` re-reads the payload and
    raises ``BorrowError`` once the guard has exited.  ``pin=True`` (used
    by ``Region.pin``) forces a real held borrow even where a plain read
    would defer to the coalescer."""

    __slots__ = ("backend", "th", "h", "_token", "_value", "_state", "_pin",
                 "_detached")

    def __init__(self, backend: ProtocolBackend, th, h, pin: bool = False):
        self.backend, self.th, self.h = backend, th, h
        self._pin = pin
        self._detached = False                 # lease guards: see detach_guard
        self._state = "new"                    # new | open | closed

    def __enter__(self):
        if self._state != "new":
            raise BorrowError("read guard re-entered")
        enter = (self.backend._enter_pin if self._pin
                 else self.backend._enter_read)
        self._token, self._value = enter(self.th, self.h)
        self._state = "open"
        _bump_guard_stat(self.backend, "pins" if self._pin else "read_guards")
        _note_open(self.backend, getattr(self.th, "tid", -1),
                   "pins" if self._pin else "read_guards", +1)
        san = self.backend.sanitizer
        if san is not None:
            self._value = san.on_read_enter(self, self._value, pin=self._pin)
        return self._value

    @property
    def value(self) -> Any:
        if self._state != "open":
            raise BorrowError("payload used outside the guard scope")
        return self._value

    def close(self) -> None:
        if self._state != "open":
            return
        self._state = "closed"
        self._value = None
        self.backend._exit_read(self.th, self.h, self._token)
        if not self._detached:
            _note_open(self.backend, getattr(self.th, "tid", -1),
                       "pins" if self._pin else "read_guards", -1)
        san = self.backend.sanitizer
        if san is not None:
            san.on_guard_close(self, "read")
        pl = self.backend.placement
        if pl is not None:
            # Guard exit is the telemetry point: the borrow just released,
            # so a triggered owner migration can never race a live borrow
            # from this guard.
            pl.note_access(self.th, self.h)

    def _abandon(self) -> None:
        """Recovery-only: retire the guard WITHOUT releasing the borrow.
        Fail-over force-releases every borrow held by a dead server's
        threads while reconstructing lock/lease state; a later ``close()``
        on such a guard would double-decrement a count the recovery ledger
        already settled.  Never call outside ``core/fault.py``-driven
        lease/lock breaking."""
        if self._state != "open":
            return
        self._state = "closed"
        self._value = None
        if not self._detached:
            _note_open(self.backend, getattr(self.th, "tid", -1),
                       "pins" if self._pin else "read_guards", -1)
        san = self.backend.sanitizer
        if san is not None:
            san.on_guard_abandon(self)

    def __exit__(self, *exc):
        self.close()
        return False


class WriteGuard:
    """``with h.write(th) as w:`` — enter = exclusive borrow, exit = drop +
    write-back.  The body mutates through the slot: ``w.value`` derefs the
    payload (mutating it in place works for heap-backed protocols and is
    written back at exit for caching ones), ``w.set(data)`` replaces it,
    ``w.update(fn)`` is read-modify-write.  All three raise ``BorrowError``
    after exit.  An exception inside the body still releases the borrow
    and flushes the write-back exactly once — RAII, not convention."""

    __slots__ = ("backend", "th", "h", "_token", "_state")

    def __init__(self, backend: ProtocolBackend, th, h):
        self.backend, self.th, self.h = backend, th, h
        self._state = "new"

    def __enter__(self) -> "WriteGuard":
        if self._state != "new":
            raise BorrowError("write guard re-entered")
        self._token = self.backend._enter_write(self.th, self.h)
        self._state = "open"
        _bump_guard_stat(self.backend, "write_guards")
        _note_open(self.backend, getattr(self.th, "tid", -1),
                   "write_guards", +1)
        san = self.backend.sanitizer
        if san is not None:
            san.on_write_enter(self)
        return self

    def _check_open(self):
        if self._state != "open":
            raise BorrowError("write slot used outside the guard scope")

    @property
    def value(self) -> Any:
        self._check_open()
        return self.backend._write_value(self.th, self.h, self._token)

    def set(self, data: Any) -> None:
        self._check_open()
        san = self.backend.sanitizer
        if san is not None:
            data = san.adopt(data)
        self.backend._write_set(self.th, self.h, self._token, data)

    def update(self, fn: Callable[[Any], Any]) -> Any:
        self._check_open()
        val = fn(self.value)
        self.set(val)
        return val

    def close(self) -> None:
        if self._state != "open":
            return
        self._state = "closed"
        self.backend._exit_write(self.th, self.h, self._token)
        _note_open(self.backend, getattr(self.th, "tid", -1),
                   "write_guards", -1)
        san = self.backend.sanitizer
        if san is not None:
            san.on_guard_close(self, "write")
        pl = self.backend.placement
        if pl is not None:
            pl.note_access(self.th, self.h, write=True)

    def __exit__(self, *exc):
        self.close()
        return False


class Region:
    """``with cluster.region(th) as r:`` — a batching scope.

    Entry hints:
      * ``r.prefetch(handles)`` — post speculative read doorbells for the
        scope's working set (no-op on backends without safe speculation);
      * ``r.pin(handles)`` — take region-lifetime immutable borrows: the
        payloads stay pinned in the local cache until the region exits;
      * ``lease=(rwlocks...)`` — take reader leases on ``DRwLock``s up
        front (one grant round trip each, amortized over every read this
        server does until a writer revokes).  Unlike pins, leases *outlive*
        the region — revocation is the writer's job, not scope exit's.

    Exit is a *settle point*: the thread's registered (coalesced) derefs
    flush as per-source ``read_many`` doorbells and its staged channel
    sends ring — exactly the work this thread touched inside the scope
    (registration and staging are per-thread, and the previous settle
    point closed the prior quantum).  Pins are released before the flush.
    Exceptions settle too — the scope *is* the lifetime.
    """

    __slots__ = ("cluster", "th", "_pins", "_state", "_prefetch", "_pin",
                 "_lease")

    def __init__(self, cluster, th, prefetch=(), pin=(), lease=()):
        self.cluster, self.th = cluster, th
        self._prefetch, self._pin = tuple(prefetch), tuple(pin)
        self._lease = tuple(lease)
        self._pins: list[ReadGuard] = []
        self._state = "new"

    def __enter__(self) -> "Region":
        if self._state != "new":
            raise BorrowError("region re-entered")
        self._state = "open"
        _bump_guard_stat(self.cluster.backend, "regions")
        _note_open(self.cluster.backend, getattr(self.th, "tid", -1),
                   "regions", +1)
        try:
            if self._prefetch:
                self.prefetch(self._prefetch)
            if self._pin:
                self.pin(self._pin)
            for rw in self._lease:
                rw.acquire_lease(self.th)
        except BaseException:
            # The with-statement never calls __exit__ when __enter__
            # raises — release any pins already taken before propagating,
            # or the hint failure would leak borrows forever.
            self._state = "closed"
            _note_open(self.cluster.backend, getattr(self.th, "tid", -1),
                       "regions", -1)
            for g in reversed(self._pins):
                g.close()
            self._pins.clear()
            raise
        return self

    def prefetch(self, handles) -> int:
        if self._state != "open":
            raise BorrowError("prefetch hint outside the region scope")
        return self.cluster.backend.prefetch(self.th, handles)

    def pin(self, handles) -> None:
        if self._state != "open":
            raise BorrowError("pin hint outside the region scope")
        for h in handles:
            g = ReadGuard(self.cluster.backend, self.th, h, pin=True)
            g.__enter__()
            self._pins.append(g)

    def __exit__(self, *exc):
        if self._state != "open":
            return False
        self._state = "closed"
        _note_open(self.cluster.backend, getattr(self.th, "tid", -1),
                   "regions", -1)
        for g in reversed(self._pins):
            g.close()
        self._pins.clear()
        self.cluster.settle(self.th)
        return False
