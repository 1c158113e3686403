"""Trace-based coherence race certifier.

Replays a sanitizer event trace (:class:`repro_torch.analysis.sanitizer.Event`)
and proves the paper's core claim as a happens-before check: **any two
conflicting accesses to a box (or its TBox tie root) are ordered by an
ownership edge** — a transfer, a write-move, ``migrate_here``, a lease
grant/revoke, or a lock hand-off — and every access observed the epoch
produced by the latest such ordered write.

Mechanics (vector clocks, release/acquire):

* Each thread carries a vector clock ``vc[tid]``, ticked per event.
* ``spawn``/``join`` join parent/child clocks; ``lock_acquire`` joins the
  lock's release clock (the hand-off edge); ``lease_grant`` joins the
  guarded box's release clock; ``lease_revoke`` joins the accumulated
  lease holders' clocks into the box's release clock.
* Every ``write_close`` bumps the box's epoch and publishes the writer's
  clock as the box's *release* clock; ``transfer`` and ``migrate_here``
  publish the mover's clock the same way (ownership hand-offs are
  release points even without a data write).
* Every ``read_open``/``write_open`` carries the epoch the access
  *observed*.  Observing the current epoch is the recorded form of the
  ownership edge — the protocol synchronized this access with the owner
  of that version — so the opener **acquires** the box's release clock.
  An access that observed an older epoch has no such edge: that is a
  replica served after its epoch bump, and certification fails.
* After acquiring, the opener's clock must dominate the box's last-write
  clock (write opens must also dominate the accumulated read clock), and
  no conflicting guard may be concurrently open — either failure is an
  unordered conflicting access.

``certify`` returns a :class:`Certificate` on success and raises
:class:`RaceError` (with the offending events) on the first violation.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .sanitizer import Event

_READ_OPEN = {"read_open", "pin_open"}
_CLOSE_OF = {"read_open": "read_close", "pin_open": "pin_close",
             "write_open": "write_close"}


class RaceError(RuntimeError):
    """Two conflicting accesses with no ordering ownership edge."""

    def __init__(self, message: str, events: list[Event] | None = None):
        self.events = list(events or [])
        if self.events:
            tail = "\n".join(
                f"  #{e.seq} {e.kind} tid={e.tid} key={e.key:#x} "
                f"epoch={e.epoch} {e.detail}".rstrip()
                for e in self.events
            )
            message = f"{message}\nevidence:\n{tail}"
        super().__init__(message)


@dataclass
class Certificate:
    """Proof summary for a certified trace."""

    events: int = 0
    boxes: int = 0
    reads: int = 0
    writes: int = 0
    edges: int = 0          # ownership edges that ordered conflicts
    threads: int = 0

    def __str__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"certified: {self.events} events, {self.boxes} boxes, "
                f"{self.reads} reads / {self.writes} writes ordered by "
                f"{self.edges} ownership edges across {self.threads} threads")


def _dominates(a: dict[int, int], b: dict[int, int]) -> bool:
    """True iff clock ``a`` >= clock ``b`` componentwise."""
    return all(a.get(t, 0) >= n for t, n in b.items())


def _join(into: dict[int, int], other: dict[int, int]) -> None:
    for t, n in other.items():
        if into.get(t, 0) < n:
            into[t] = n


@dataclass
class _Box:
    epoch: int = 0
    release: dict[int, int] = field(default_factory=dict)  # last hand-off
    wvc: dict[int, int] = field(default_factory=dict)      # last write_close
    rvc: dict[int, int] = field(default_factory=dict)      # joined read_closes
    lease_rel: dict[int, int] = field(default_factory=dict)
    open_read: dict[int, Event] = field(default_factory=dict)   # tid -> open
    open_write: tuple[int, Event] | None = None
    last_write: Event | None = None


def certify(trace: list[Event]) -> Certificate:
    """Replay ``trace``; raise :class:`RaceError` on the first unordered
    conflicting access, else return a :class:`Certificate`."""
    vc: dict[int, dict[int, int]] = {}
    boxes: dict[int, _Box] = {}
    lock_rel: dict[int, dict[int, int]] = {}
    cert = Certificate(events=len(trace))

    def clock(tid: int) -> dict[int, int]:
        c = vc.get(tid)
        if c is None:
            c = vc[tid] = {tid: 0}
        return c

    def tick(tid: int) -> dict[int, int]:
        c = clock(tid)
        c[tid] = c.get(tid, 0) + 1
        return c

    for e in trace:
        kind = e.kind
        if kind in _READ_OPEN or kind == "write_open":
            c = tick(e.tid)
            box = boxes.setdefault(e.key, _Box())
            # -- epoch consistency: the recorded ownership edge ----------
            if e.epoch != box.epoch:
                raise RaceError(
                    f"{'stale replica' if e.epoch < box.epoch else 'phantom epoch'}: "
                    f"tid {e.tid} {kind} on key {e.key:#x} observed epoch "
                    f"{e.epoch} but the last ordered write produced epoch "
                    f"{box.epoch} — no ownership edge orders this access",
                    [x for x in (box.last_write, e) if x is not None])
            _join(c, box.release)        # acquire the hand-off edge
            if box.release:
                cert.edges += 1
            # -- direct conflict: overlapping guards ---------------------
            if box.open_write is not None and box.open_write[0] != e.tid:
                raise RaceError(
                    f"conflicting open guards: tid {e.tid} {kind} while tid "
                    f"{box.open_write[0]}'s write guard is open on key "
                    f"{e.key:#x}", [box.open_write[1], e])
            if kind == "write_open":
                others = [t for t in box.open_read if t != e.tid]
                if others:
                    raise RaceError(
                        f"conflicting open guards: tid {e.tid} write_open "
                        f"while tid {others[0]}'s read guard is open on key "
                        f"{e.key:#x}", [box.open_read[others[0]], e])
            # -- happens-before: the access must see the last write ------
            if not _dominates(c, box.wvc):
                raise RaceError(
                    f"unordered conflicting access: tid {e.tid} {kind} on "
                    f"key {e.key:#x} does not happen-after the last write",
                    [x for x in (box.last_write, e) if x is not None])
            if kind == "write_open":
                if not _dominates(c, box.rvc):
                    raise RaceError(
                        f"unordered write: tid {e.tid} write_open on key "
                        f"{e.key:#x} does not happen-after prior reads",
                        [e])
                box.open_write = (e.tid, e)
                cert.writes += 1
            else:
                box.open_read[e.tid] = e
                cert.reads += 1

        elif kind in ("read_close", "pin_close", "lease_close"):
            c = tick(e.tid)
            box = boxes.setdefault(e.key, _Box())
            box.open_read.pop(e.tid, None)
            _join(box.rvc, c)
            _join(box.release, c)        # a reader release is a hand-off too

        elif kind == "write_close":
            c = tick(e.tid)
            box = boxes.setdefault(e.key, _Box())
            if box.open_write is not None and box.open_write[0] == e.tid:
                box.open_write = None
            box.epoch = e.epoch
            box.wvc = dict(c)
            box.release = dict(c)        # publish: the ownership hand-off
            box.last_write = e

        elif kind in ("transfer", "migrate_here"):
            c = tick(e.tid)
            box = boxes.setdefault(e.key, _Box())
            _join(c, box.release)        # mover synchronizes with the owner
            box.release = dict(c)
            cert.edges += 1

        elif kind == "lease_grant":
            c = tick(e.tid)
            box = boxes.setdefault(e.key, _Box())
            _join(c, box.release)        # grant pays the cold read: acquire
            _join(box.lease_rel, c)
            cert.edges += 1

        elif kind == "lease_revoke":
            c = tick(e.tid)
            box = boxes.setdefault(e.key, _Box())
            _join(c, box.lease_rel)      # writer collects the lease holders
            box.lease_rel = {}
            _join(box.release, c)
            cert.edges += 1

        elif kind == "lock_acquire":
            c = tick(e.tid)
            _join(c, lock_rel.get(e.key, {}))
            if lock_rel.get(e.key):
                cert.edges += 1

        elif kind == "lock_release":
            c = tick(e.tid)
            lock_rel[e.key] = dict(c)

        elif kind == "spawn":
            c = tick(e.tid)
            if e.src is not None:
                _join(c, clock(e.src))

        elif kind == "join":
            c = tick(e.tid)
            if e.src is not None:
                _join(c, clock(e.src))

        elif kind == "guard_abandon":
            box = boxes.setdefault(e.key, _Box())
            box.open_read.pop(e.tid, None)
            if box.open_write is not None and box.open_write[0] == e.tid:
                box.open_write = None

        elif kind == "failover":
            # recovery force-released the dead threads' borrows: any guard
            # still open for a tid we never see again is settled there.
            for box in boxes.values():
                if box.open_write is not None:
                    box.open_write = None
                box.open_read.clear()

        # verb_post / fence / forget / spec_* / retire / migrate events are
        # provenance; they do not move the happens-before frontier.

    cert.boxes = len(boxes)
    cert.threads = len(vc)
    return cert
