"""DRust's ownership-guided coherence protocol (paper §4.1.1, Appendix B).

The user-facing surface is the **scoped-guard API** (``core/protocol.py``):

    with box.read(th) as v:        # enter = immutable borrow + deref
        use(v)                     # body  = the deref'd payload
                                   # exit  = DropRef (release the pin)

    with box.write(th) as w:       # enter = exclusive mutable borrow
        w.set(new_value)           # deref_mut + store
                                   # exit  = DropMutRef (the write-back)

    with cluster.region(th) as r:  # batching scope (see core/runtime.py)
        r.prefetch(boxes)          # speculative read doorbells
        ...                        # exit = coalescer settle point

The guard scope *is* the borrow lifetime, so the runtime is told the settle
points (quantum close, write-back, release) instead of inferring them, and
an exception inside a guard body structurally releases the borrow — no
unbalanced-drop leaks.  The legacy call-pair surface
(``backend.read/write/update/free``) is kept as a thin shim implemented on
top of the guards, charging byte-identical costs.

Legacy call pairs → guard surface migration:

    ====================================  ===================================
    legacy (manual call pairs)            scoped guards
    ====================================  ===================================
    ``r = box.borrow(th)``                ``with box.read(th) as v: ...``
    ``v = r.deref(th); r.drop(th)``
    ``m = box.borrow_mut(th)``            ``with box.write(th) as w:``
    ``m.deref_mut(th); ...; m.drop(th)``  ``    w.set(x)  # or w.value / w.update(fn)``
    ``val = backend.read(th, box)``       unchanged (shim over the read guard)
    ``backend.write(th, box, x)``         unchanged (shim over the write guard)
    ``backend.prefetch(th, boxes)``       ``with cluster.region(th) as r: r.prefetch(boxes)``
    ``val, ref = read_cached(th, box)``   ``r.pin(boxes)`` inside a region
    ====================================  ===================================

Underneath, the protocol is implemented operation-for-operation:

  * Algorithm 4  — immutable-reference Deref / DropRef (cache hashmap H)
  * Algorithm 6  — mutable-reference DerefMut (move-on-remote-write, pointer
                   coloring + U bit on local write) / DropMutRef (owner
                   write-back of the colored address)
  * Algorithm 7  — owner immutable access (borrow+return pair)
  * Algorithm 8  — owner mutable access (incl. adopting an existing local
                   cache copy instead of re-copying)
  * Algorithm 3/5 — color utilities (see ``addr``), move-on-overflow
  * Appendix D.1 — stack values / partial borrows (copy + write-back)
  * Appendix D.2 — reference creation & ownership transfer (cache eviction)
  * §4.1.3       — TBox affinity groups (batched group fetch/move, check-free
                   deref) and spawn_to support hooks

``DrustRuntime`` implements the backend-generic ``ProtocolBackend`` ABC —
the same verb surface as the GAM/Grappa baselines — so the applications are
backend-generic; only DRust's implementation threads real ownership state
through the verbs.

Python has no borrow checker, so Rust's *static* guarantees are enforced
dynamically: every DBox tracks live borrows and raises ``BorrowError`` on
violations — the tests drive only programs a Rust compiler would accept, and
the hypothesis suite checks the protocol's coherence lemmas (Appendix C).

Colors are authoritative in *pointers* (exactly as in the paper); the heap
keeps a mirror (``obj_color``) only so batched TBox group fetches can key
children cache entries without threading every handle through the runtime —
the mirror is bookkeeping, not protocol state.
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Callable

from . import addr as A
from .cache import LocalCache
from .heap import GlobalHeap, Obj
from .net import ServerLostError, Sim
from .protocol import (BorrowError, ProtocolBackend, ReadGuard, WriteGuard,
                       register_backend)


try:
    import numpy as _np
except Exception:      # pragma: no cover
    _np = None

_SCALARS = (bytes, int, float, str, bool, complex, type(None))


def _clone(data: Any) -> Any:
    """Payload snapshot.  Scalars pass through; flat lists/tuples/dicts of
    scalars and numpy arrays take a shallow-copy fast path (no memo dict, no
    recursion); everything else falls back to ``deepcopy``."""
    if isinstance(data, _SCALARS):
        return data
    if _np is not None and isinstance(data, _np.ndarray):
        return data.copy()
    if isinstance(data, list):
        if all(isinstance(x, _SCALARS) for x in data):
            return list(data)
    elif isinstance(data, tuple):
        if all(isinstance(x, _SCALARS) for x in data):
            return data
    elif isinstance(data, dict):
        if all(isinstance(k, _SCALARS) and isinstance(v, _SCALARS)
               for k, v in data.items()):
            return dict(data)
    return _copy.deepcopy(data)


class DBox:
    """Owner pointer (DRust's ``DBox<T>``, re-implemented ``Box``)."""

    __slots__ = ("g", "l", "u", "home", "rt", "live_refs", "live_mut",
                 "dropped", "tied", "wb_cids", "fetch_cid", "fetch_server",
                 "lost", "mut_broken", "mut_tid", "ref_tids", "site")

    def __init__(self, rt: "DrustRuntime", g: int, home: int, tied: bool = False):
        self.rt = rt
        self.g = g          # colored global address (word 0)
        self.l = A.NULL     # ext word, read path: local cache copy address
        self.u = False      # ext word, write path: U bit
        self.home = home    # server hosting the *pointer* (for write-back cost)
        self.live_refs = 0
        self.live_mut = False
        self.dropped = False
        self.tied = tied    # this owner is a TBox (affinity-tied to a parent)
        self.wb_cids: list[int] = []   # in-flight write-back completion ids
        self.fetch_cid = 0             # in-flight speculative prefetch cid
        self.fetch_server: int | None = None   # server that prefetched
        # Recovery state (all no-ops on the no-failure path).
        self.lost = False        # payload died unrecoverably with its server
        self.mut_broken = False  # open WriteGuard's home died: the pending
        #   mutation can never be written back — the guard surfaces
        #   ServerLostError and releases without write-back
        self.mut_tid: int | None = None   # tid holding the mutable borrow
        self.ref_tids: dict[int, int] = {}  # tid -> live read borrows held
        # Placement override: the server a ``transfer`` shipped the owner
        # to.  None = the payload location (``server_of(g)``) is the
        # placement target; any payload relocation clears the override —
        # the data caught up with (or overtook) the pointer.
        self.site: int | None = None

    def __repr__(self):
        return (f"DBox(g={A.clear_color(self.g):#x}c{A.get_color(self.g)}, "
                f"l={self.l:#x}, u={self.u})")

    # Scoped-guard surface -------------------------------------------------
    def read(self, th) -> ReadGuard:
        """``with box.read(th) as v:`` — scoped immutable borrow."""
        return ReadGuard(self.rt, th, self)

    def write(self, th) -> WriteGuard:
        """``with box.write(th) as w:`` — scoped mutable borrow; exit is
        the DropMutRef write-back."""
        return WriteGuard(self.rt, th, self)

    # Rust surface: borrows ------------------------------------------------
    def borrow(self, th) -> "Ref":
        self._check_live()
        if self.live_mut:
            raise BorrowError("immutable borrow while mutable borrow alive")
        self.live_refs += 1
        tid = getattr(th, "tid", 0)
        self.ref_tids[tid] = self.ref_tids.get(tid, 0) + 1
        self.u = False                      # B.4: creating & ref resets U
        return Ref(self.rt, self.g, owner=self, tid=tid)

    def borrow_mut(self, th) -> "MutRef":
        self._check_live()
        self.rt._coalesce_conflict(self)    # flush pending registered derefs
        if self.live_mut or self.live_refs:
            raise BorrowError("mutable borrow while other borrows alive")
        self.rt._invalidate_prefetch(self)  # speculative bytes go stale
        self._release_pin()                 # owner's cached copy unpinned
        self.live_mut = True
        self.mut_tid = getattr(th, "tid", 0)
        return MutRef(self.rt, self.g, owner=self, u=self.u)

    def _check_live(self):
        if self.dropped:
            raise BorrowError("use after drop")
        if self.lost:
            raise ServerLostError(
                A.server_of(self.g),
                "object lost with its home server (no replica to restore)")

    def _release_pin(self):
        if self.l != A.NULL:
            self.rt.caches[A.server_of(self.l)].dec(self.g)
            self.l = A.NULL


class Ref:
    """Shared immutable reference (``&T``)."""

    __slots__ = ("rt", "g", "l", "owner", "dropped", "tid")

    def __init__(self, rt: "DrustRuntime", g: int, owner: DBox | None,
                 tid: int = 0):
        self.rt = rt
        self.g = g          # colored global address, copied at creation (D.2)
        self.l = A.NULL     # local copy address (filled on first deref)
        self.owner = owner
        self.dropped = False
        self.tid = tid      # borrower thread (recovery releases dead holders)

    def clone(self) -> "Ref":
        """New ref from a ref: copies only the global address (D.2)."""
        if self.owner is not None:
            self.owner.live_refs += 1
            tids = self.owner.ref_tids
            tids[self.tid] = tids.get(self.tid, 0) + 1
        return Ref(self.rt, self.g, self.owner, tid=self.tid)

    def deref(self, th) -> Any:
        """Algorithm 4."""
        assert not self.dropped
        rt, sim = self.rt, self.rt.sim
        sim.deref_check(th)
        if A.server_of(self.g) == th.server:                 # IsLocal
            sim.local_access(th)
            return rt.heap.get(A.clear_color(self.g)).data
        if self.l == A.NULL:
            H = rt.caches[th.server]
            sim.busy(th, sim.cost.hashmap_us)
            e = H.lookup(self.g)
            if e is not None:                                # lines 7-10
                rt._touch_spec(th, H, self.g, e, self.owner)
                self.l = e.local
                e.refcount += 1
            else:                                            # lines 11-13
                self.l = rt._copy_in(th, self.g)
                H.insert(self.g, self.l, refcount=1)
        sim.local_access(th)
        return rt.heap.get(self.l).data

    def drop(self, th) -> None:
        """DropRef: release the cache pin."""
        if self.dropped:
            return
        self.dropped = True
        if self.l != A.NULL:
            self.rt.caches[th.server].dec(self.g)
            self.l = A.NULL
        if self.owner is not None:
            self.owner.live_refs -= 1
            tids = self.owner.ref_tids
            left = tids.get(self.tid, 0) - 1
            if left > 0:
                tids[self.tid] = left
            else:
                tids.pop(self.tid, None)


class MutRef:
    """Exclusive mutable reference (``&mut T``)."""

    __slots__ = ("rt", "g", "u", "owner", "dropped", "accessed")

    def __init__(self, rt: "DrustRuntime", g: int, owner: DBox, u: bool):
        self.rt = rt
        self.g = g
        self.u = u          # U bit of the extension word (owner addr | U)
        self.owner = owner
        self.dropped = False
        self.accessed = False

    def deref_mut(self, th) -> Any:
        """Algorithm 6: returns the payload at a local, writable address."""
        assert not self.dropped
        if self.owner.mut_broken:
            raise ServerLostError(
                A.server_of(self.owner.g),
                "mutable borrow broken: the object's home server failed")
        rt, sim = self.rt, self.rt.sim
        sim.deref_check(th)
        self.accessed = True
        if A.server_of(self.g) == th.server:                 # local write
            if not self.u:                                   # lines 3-6
                self.u = True
                g2, overflow = A.bump_color(self.g)
                if overflow:                                 # move-on-overflow
                    g2 = A.append_color(rt._move_local(th, self.g), 0)
                self.g = g2
                rt._mirror_color(self.g)
        else:                                                # lines 7-9
            self.u = True
            self.g = A.append_color(rt._move_in(th, self.g), A.get_color(self.g))
            rt._mirror_color(self.g)
        sim.local_access(th)
        return rt.heap.get(A.clear_color(self.g)).data

    def set(self, th, data: Any) -> None:
        obj = self.rt.heap.get(A.clear_color(self.deref_and_addr(th)))
        obj.data = data

    def deref_and_addr(self, th) -> int:
        self.deref_mut(th)
        return A.clear_color(self.g)

    def drop(self, th) -> None:
        """DropMutRef: WRITE the colored address back into the owner slot.

        The 8-byte pointer write-back is posted on the async write-back
        queue: the dropping thread pays only the issue cost; the verb's
        completion id is recorded on the owner so synchronization points
        (ownership transfer, drop-time dealloc, makespan) fence exactly the
        ids they depend on — the next owner access goes through the new
        address regardless, so coherence (Appendix C) is unaffected."""
        if self.dropped:
            return
        self.dropped = True
        rt, owner = self.rt, self.owner
        if owner.mut_broken:
            # Guard-aware fail-over: the object's home died while this
            # mutable borrow was open.  The pending mutation can never be
            # written back (the restored replica reverts to the last flushed
            # epoch) — release the borrow WITHOUT posting a write-back and
            # without committing the speculative colored address, then
            # surface the loss structurally.
            owner.mut_broken = False
            owner.live_mut = False
            owner.mut_tid = None
            raise ServerLostError(
                A.server_of(owner.g),
                "write-back impossible: home server failed mid-mutation "
                "(un-flushed write lost, reverted to last flushed epoch)")
        if owner.home != th.server:
            if rt.batch_io:
                owner.wb_cids.append(
                    rt.sim.wb.post(th, owner.home, 8))       # pipelined WRITE
            else:
                rt.sim.rdma_write(th, owner.home, 8)         # sync WRITE
        else:
            rt.sim.local_access(th)
        owner.g = self.g
        owner.u = self.u
        owner.l = A.NULL       # stale read-path ext cannot survive a new g
        owner.live_mut = False
        owner.mut_tid = None
        if self.accessed:
            rt.on_write_visible(A.clear_color(self.g))       # FT write-back hook


class StackRef:
    """Appendix D.1: mutable borrow of a stack value / struct part.

    The borrowed bytes are *copied* to the borrowing server and written back
    on drop (the address cannot change); the parent owner's color is bumped
    atomically so remote caches of the parent miss afterwards.
    """

    __slots__ = ("rt", "parent", "data", "size", "src_server", "dropped")

    def __init__(self, rt: "DrustRuntime", parent: DBox, data: Any, size: int,
                 src_server: int):
        self.rt, self.parent = rt, parent
        self.data, self.size, self.src_server = data, size, src_server
        self.dropped = False

    def deref_mut(self, th) -> Any:
        self.rt.sim.deref_check(th)
        self.rt.sim.local_access(th)
        return self.data

    def drop(self, th) -> None:
        if self.dropped:
            return
        self.dropped = True
        rt = self.rt
        if th.server != self.src_server:
            if rt.batch_io:
                cid = rt.sim.wb.post(th, self.src_server, self.size)
                if self.parent is not None:   # transfer of the parent fences it
                    self.parent.wb_cids.append(cid)
            else:
                rt.sim.rdma_write(th, self.src_server, self.size)
        else:
            rt.sim.local_access(th, self.size)
        if self.parent is not None:
            g2, overflow = A.bump_color(self.parent.g)
            if overflow:
                g2 = A.append_color(rt._move_local(th, self.parent.g), 0)
            self.parent.g = g2
            rt._mirror_color(self.parent.g)
            self.parent.live_mut = False
            rt.on_write_visible(A.clear_color(self.parent.g))


@register_backend
class DrustRuntime(ProtocolBackend):
    """Per-cluster protocol engine: heap + caches + the op implementations.

    Implements the backend-generic ``ProtocolBackend`` verb surface (it IS
    the drust backend — the old ``DrustBackend`` facade survives as a thin
    deprecated shim), plus the owner/borrow primitives the guards build on.

    ``batch_io`` selects the communication plane: ``True`` (default) uses
    doorbell coalescing for group fetches and the async pipeline for
    write-backs; ``False`` reproduces the naive plane — one verb per object,
    synchronous write-backs — for A/B cost ablations.  Protocol *state* is
    identical under both planes; only the cost accounting differs.
    """

    name = "drust"
    supports_ownership = True
    supports_affinity = True
    supports_prefetch = True
    supports_coalescing = True

    def __init__(self, sim: Sim, heap: GlobalHeap | None = None,
                 batch_io: bool = True):
        self.sim = sim
        self.batch_io = batch_io
        self.heap = heap or GlobalHeap(sim.n)
        self.caches = [LocalCache(s, self.heap.partitions[s])
                       for s in range(sim.n)]
        self.owner_of: dict[int, DBox] = {}    # raw addr -> unique owner handle
        self.obj_color: dict[int, int] = {}    # bookkeeping mirror (see module doc)
        self.tie_parent: dict[int, int] = {}   # raw child -> raw tie parent
        # fault-tolerance hook; replaced by repro_torch.core.fault.Replicator
        self.on_write_visible: Callable[[int], None] = lambda raw: None
        self.on_alloc: Callable[[int], None] = lambda raw: None
        self.on_free: Callable[[int], None] = lambda raw: None
        self.on_transfer: Callable[[int], None] = lambda raw: None
        self.on_move: Callable[[int, int], None] = lambda old, new: None
        # Deref coalescer (installed by Cluster under ``coalesce="auto"``);
        # None = every deref fetches eagerly (the manual plane).
        self.coalescer = None
        # Speculative-prefetch ledger: every posted prefetch cid, and its
        # disposition ("fenced" at first use | "invalidated" before use).
        # The staleness-safety property suite checks every cid is disposed
        # exactly once.
        self.spec_cids: list[int] = []
        self.spec_log: dict[int, str] = {}
        for H in self.caches:
            H.on_spec_drop = (
                lambda cid: self._dispose_spec(cid, "invalidated"))

    # ---- guard hooks (the scoped-borrow surface) -------------------------
    def _enter_read(self, th, box: DBox):
        """Read-guard entry: register with the coalescer when it wants the
        deref (the registration borrow is owned by the coalescer and drops
        at the flush), else take the borrow eagerly (Algorithm 4)."""
        co = self.coalescer
        if co is not None and co.wants(th, box):
            return None, co.register(th, box)
        r = box.borrow(th)
        return r, r.deref(th)

    def _exit_read(self, th, box: DBox, token) -> None:
        if token is not None:
            token.drop(th)

    def _enter_pin(self, th, box: DBox):
        """Region pin: always the eager held borrow (never a coalescer
        registration — a registration flushes on a conflicting write
        instead of excluding it, which is the opposite of a pin)."""
        r = box.borrow(th)
        return r, r.deref(th)

    def _enter_write(self, th, box: DBox):
        return box.borrow_mut(th)

    def _write_value(self, th, box: DBox, m: "MutRef") -> Any:
        return m.deref_mut(th)

    def _write_set(self, th, box: DBox, m: "MutRef", data: Any) -> None:
        if not m.accessed:
            m.deref_mut(th)                  # first touch: Algorithm 6
        self.heap.get(A.clear_color(m.g)).data = data

    def _exit_write(self, th, box: DBox, m: "MutRef") -> None:
        m.drop(th)                           # DropMutRef: the write-back

    # ---- whole-object verbs (thin shims over the guards) -----------------
    def read(self, th, box: DBox) -> Any:
        with ReadGuard(self, th, box) as v:
            # Whole-object read is copy-out: the caller keeps the value
            # past the internal guard, so hand out a plain copy, never the
            # guard-scoped (sanitize: tombstoned) snapshot.
            return v if self.sanitizer is None else self.sanitizer.adopt(v)

    def write(self, th, box: DBox, data: Any) -> None:
        with WriteGuard(self, th, box) as w:
            w.set(data)

    def read_cached(self, th, box: DBox) -> tuple[Any, "Ref"]:
        """Long-lived immutable borrow (caller drops); prefer
        ``Region.pin`` on the guard surface."""
        r = box.borrow(th)
        return r.deref(th), r

    def drop(self, th, box: DBox) -> None:
        self.drop_box(th, box)

    # ---- allocation ------------------------------------------------------
    def alloc(self, th, size: int, data: Any = None, server: int | None = None,
              tie_to: DBox | None = None) -> DBox:
        """Global allocation (§4.2.1): local-first, controller may redirect.

        ``tie_to`` makes this a TBox allocation: the object is co-located
        with (and tied to) its owner object's partition.
        """
        if tie_to is not None:
            server = A.server_of(tie_to.g)
        elif server is None:
            server = th.server
        self.sim.busy(th, self.sim.cost.alloc_us)
        if server != th.server:
            self.sim.rpc(th, server, req_bytes=64 + (size if data is not None else 0))
        raw = self.heap.alloc_on(server, size, data)
        box = DBox(self, A.append_color(raw, 0), home=th.server,
                   tied=tie_to is not None)
        self.owner_of[raw] = box
        self.obj_color[raw] = 0
        if tie_to is not None:
            parent_raw = A.clear_color(tie_to.g)
            self.heap.get(parent_raw).ties.append(raw)
            self.tie_parent[raw] = parent_raw
        self.on_alloc(raw)
        th.local_heap_bytes += size if server == th.server else 0
        return box

    def stack_val(self, th, size: int, data: Any) -> DBox:
        """A stack value exposed for borrowing (D.1): modeled as an object in
        the thread's partition that is never moved (address pinned)."""
        raw = self.heap.alloc_on(th.server, size, data)
        box = DBox(self, A.append_color(raw, 0), home=th.server)
        self.owner_of[raw] = box
        self.obj_color[raw] = 0
        return box

    # ---- owner direct access (Algorithms 7/8) ----------------------------
    def owner_read(self, th, box: DBox) -> Any:
        """Algorithm 7 (a borrow+return pair; resets U per B.4)."""
        box._check_live()
        if box.live_mut:
            raise BorrowError("owner read while mutable borrow alive")
        sim = self.sim
        sim.deref_check(th)
        box.u = False
        if A.server_of(box.g) == th.server:
            sim.local_access(th)
            return self.heap.get(A.clear_color(box.g)).data
        if box.l == A.NULL:
            H = self.caches[th.server]
            sim.busy(th, sim.cost.hashmap_us)
            e = H.lookup(box.g)
            if e is not None:
                self._touch_spec(th, H, box.g, e, box)
                box.l = e.local
                e.refcount += 1
            else:
                box.l = self._copy_in(th, box.g)
                H.insert(box.g, box.l, refcount=1)
        sim.local_access(th)
        return self.heap.get(box.l).data

    def owner_write(self, th, box: DBox, fn: Callable[[Any], Any] | None = None,
                    data: Any = None) -> Any:
        """Algorithm 8 (incl. adopting an existing local cache copy)."""
        box._check_live()
        self._coalesce_conflict(box)
        if box.live_mut or box.live_refs:
            raise BorrowError("owner write while borrows alive")
        self._invalidate_prefetch(box)
        box._release_pin()
        sim = self.sim
        sim.deref_check(th)
        if A.server_of(box.g) == th.server:
            if not box.u:                                    # lines 3-6
                box.u = True
                g2, overflow = A.bump_color(box.g)
                if overflow:
                    g2 = A.append_color(self._move_local(th, box.g), 0)
                box.g = g2
                self._mirror_color(box.g)
        else:
            H = self.caches[th.server]
            sim.busy(th, sim.cost.hashmap_us)
            e = H.lookup(box.g)
            if e is None:                                    # lines 8-10
                box.u = True
                box.g = A.append_color(self._move_in(th, box.g),
                                       A.get_color(box.g))
            else:                                            # lines 11-16: adopt
                H.remove(box.g)
                old_raw = A.clear_color(box.g)
                new_raw = e.local
                # the adopted copy inherits the tie edges of the original
                self.heap.get(new_raw).ties = list(self.heap.get(old_raw).ties)
                self._relocate_tie_links(old_raw, new_raw)
                self._dealloc_remote(th, old_raw)
                self.owner_of.pop(old_raw, None)
                self.owner_of[new_raw] = box
                self.obj_color[new_raw] = A.get_color(box.g)
                box.g = A.append_color(new_raw, A.get_color(box.g))
                box.u = True
                box.site = None        # adopted copy: payload relocated
            box.l = A.NULL
            self._mirror_color(box.g)
        sim.local_access(th)
        obj = self.heap.get(A.clear_color(box.g))
        if fn is not None:
            obj.data = fn(obj.data)
        elif data is not None:
            obj.data = data
        self.on_write_visible(A.clear_color(box.g))
        return obj.data

    # ---- drop / transfer ---------------------------------------------------
    def drop_box(self, th, box: DBox) -> None:
        """Owner out of scope: drop of the whole tied closure, dealloc, and
        async invalidation of cached copies on every server (B.4).

        Dealloc requests and invalidations for the closure are *coalesced*:
        one async message per remote server carrying every freed address
        (instead of one per object), and one invalidation scrub per cache."""
        if box.dropped:
            return
        self._coalesce_conflict(box)
        if box.live_mut or box.live_refs:
            raise BorrowError("drop while borrows alive")
        stack, group = [box], []
        wb_upto = 0
        while stack:
            b = stack.pop()
            if b.dropped:
                continue
            self._coalesce_conflict(b)
            if b.live_mut or b.live_refs:
                raise BorrowError("drop while borrows alive")
            b._release_pin()
            b.dropped = True
            if b.wb_cids:
                wb_upto = max(wb_upto, max(b.wb_cids))
                b.wb_cids.clear()
            if b.fetch_cid:
                # B.4 dealloc: an in-flight speculative READ of the dropped
                # slots must complete before they are freed — fence its cid
                # like a write-back; the unused entries are invalidated.
                wb_upto = max(wb_upto, b.fetch_cid)
                self._invalidate_prefetch(b)
            raw = A.clear_color(b.g)
            if not self.heap.contains(raw):
                continue
            group.append(raw)
            for child in list(self.heap.get(raw).ties):
                child_box = self.owner_of.get(child)
                if child_box is not None and not child_box.dropped:
                    stack.append(child_box)
        if wb_upto:
            # B.4 dealloc: in-flight owner-slot write-backs into the dropped
            # closure must complete before the slots are freed (the NIC may
            # not WRITE into recycled memory) — fence only those ids.
            self.sim.wb.fence(th, wb_upto)
        if not group:
            return
        remote: dict[int, int] = {}              # server -> freed addr count
        freed = set(group)
        for raw in group:
            s = A.server_of(raw)
            if s != th.server:
                remote[s] = remote.get(s, 0) + 1
            self.heap.free(raw)
            self.on_free(raw)
            self.owner_of.pop(raw, None)
            self.obj_color.pop(raw, None)
            self._unlink_tie(raw, freed)
        if self.batch_io:
            for s, n in remote.items():
                self.sim.async_msg(s, 16 * n)    # one coalesced dealloc req
        else:
            for s, n in remote.items():
                for _ in range(n):
                    self.sim.async_msg(s, 16)    # naive: one req per object
        self._async_invalidate_many(group)

    def transfer(self, th_src, box: DBox, dst_server: int) -> None:
        """Ownership transfer between threads/servers (D.2): only the pointer
        moves; the source server's cache copy is deallocated."""
        self._coalesce_conflict(box)
        if box.live_mut or box.live_refs:
            raise BorrowError("transfer while borrows alive")
        if box.l != A.NULL:
            H = self.caches[A.server_of(box.l)]
            H.dec(box.g)
            e = H.entries.get(box.g)
            if e is not None and e.refcount <= 0:
                H.remove(box.g)
                part = self.heap.partitions[A.server_of(box.l)]
                if part.contains(box.l):
                    part.free(box.l)
            box.l = A.NULL
        # §4.2.3: ownership transfer is the visibility point — fence exactly
        # the write-back completion ids this pointer depends on (the box's
        # own and its tied children's), plus any in-flight speculative
        # prefetch of the moving closure (the NIC's READ must complete
        # before the object can move; the unused speculative entries are
        # invalidated — ownership moved before first use).  Later verbs
        # stay in flight.
        upto = max(self._take_wb_deps(box), self._take_spec_deps(box))
        if upto:
            self.sim.wb.fence(th_src, upto)
        self.sim.rpc(th_src, dst_server, req_bytes=16)   # ship the pointer
        box.home = dst_server
        box.site = dst_server          # data-affinity now follows the owner
        # ... and flush batched write-backs to the backup partition now.
        self.on_transfer(A.clear_color(box.g))
        if self.sanitizer is not None:
            self.sanitizer.note_transfer(th_src, box, dst_server)

    # ---- placement (telemetry-driven; see core/runtime.py) ---------------
    def locate(self, box: DBox) -> int:
        """Current data-affinity target: a ``transfer``'s destination while
        the payload has not caught up (``site``), else the payload's server
        — ``g`` is rewritten on every write-move, so this tracks live
        relocations that the allocation-time home does not."""
        if box.site is not None:
            return box.site
        return A.server_of(box.g)

    def placement_root(self, box: DBox) -> DBox:
        """The owner a placement decision actually moves: a TBox child
        migrates with (and its accesses count toward) its tie root, so the
        affinity group always moves as one closure."""
        raw = A.clear_color(box.g)
        seen: set[int] = set()
        while raw in self.tie_parent and raw not in seen:
            seen.add(raw)
            raw = self.tie_parent[raw]
        root = self.owner_of.get(raw)
        return root if root is not None else box

    def migrate_here(self, th, box: DBox) -> bool:
        """Live owner migration (placement subsystem): relocate ``box``'s
        payload — with its whole TBox closure, batched as one move — into
        ``th.server``'s partition and re-home the owner pointer there.

        Same synchronization discipline as ``transfer``: registered derefs
        flush first, the move is refused while any borrow in the closure
        is live, and exactly the write-back / speculative completion ids
        the closure depends on are fenced.  The *accessing* thread pays
        the move (hot-accessor pull).  Returns False when the migration is
        suppressed or unnecessary."""
        if box.dropped or box.lost or box.mut_broken:
            return False
        box = self.placement_root(box)   # a TBox child moves with its root
        if box.dropped or box.lost or box.mut_broken:
            return False
        raw = A.clear_color(box.g)
        if not self.heap.contains(raw):
            return False
        if A.server_of(box.g) == th.server:
            box.site = None            # payload already local: drop override
            return False
        self._coalesce_conflict(box)
        owners = [box]
        for a in self._group(raw):
            child = self.owner_of.get(a)
            if child is not None and child is not box:
                owners.append(child)
        if any(b.live_mut or b.live_refs for b in owners):
            return False               # suppressed: a borrow is live
        net = self.sim.net
        rt0 = net.round_trips
        upto = max(self._take_wb_deps(box), self._take_spec_deps(box))
        if upto:
            self.sim.wb.fence(th, upto)
        box._release_pin()
        new_raw = self._move_in(th, box.g)
        box.g = A.append_color(new_raw, A.get_color(box.g))
        self._mirror_color(box.g)
        box.l = A.NULL
        if box.home != th.server:      # pointer re-home control message
            self.sim.rpc(th, box.home, req_bytes=16)
        box.home = th.server
        box.site = None
        self.on_transfer(new_raw)      # replica epoch follows the owner
        if self.sanitizer is not None:
            self.sanitizer.note_migrate_here(th, box)
        net.owner_migrations += 1
        net.migration_round_trips += net.round_trips - rt0
        return True

    # ---- internals ---------------------------------------------------------
    def _take_wb_deps(self, box: DBox) -> int:
        """Collect (and clear) the in-flight write-back completion ids a
        synchronization point on ``box`` depends on: the box's own pending
        owner-slot write-backs plus its TBox closure's (a group move ships
        the whole closure).  Returns the highest dependent cid (0 = none) —
        the ``upto_id`` for a completion-id fence."""
        upto = max(box.wb_cids, default=0)
        box.wb_cids.clear()
        raw = A.clear_color(box.g)
        if self.heap.contains(raw):
            for a in self._group(raw):
                child = self.owner_of.get(a)
                if child is not None and child is not box and child.wb_cids:
                    upto = max(upto, max(child.wb_cids))
                    child.wb_cids.clear()
        return upto

    def _take_spec_deps(self, box: DBox) -> int:
        """Speculative-fetch analogue of ``_take_wb_deps``: collect (and
        clear) the in-flight prefetch cids of ``box`` and its TBox closure,
        invalidating their unused speculative cache entries.  Returns the
        highest dependent cid (0 = none)."""
        boxes = [box]
        raw = A.clear_color(box.g)
        if self.heap.contains(raw):
            for a in self._group(raw):
                child = self.owner_of.get(a)
                if child is not None and child is not box:
                    boxes.append(child)
        upto = 0
        for b in boxes:
            if b.fetch_cid:
                upto = max(upto, b.fetch_cid)
                self._invalidate_prefetch(b)
        return upto

    # ---- speculative prefetch ------------------------------------------
    def _dispose_spec(self, cid: int, how: str) -> bool:
        """Record a speculative cid's disposition exactly once: ``fenced``
        (materialized at first use) or ``invalidated`` (killed before use).
        Returns False when the cid was already disposed."""
        if cid == 0 or cid in self.spec_log:
            return False
        self.spec_log[cid] = how
        if how == "fenced":
            self.sim.net.late_fences += 1
        else:
            self.sim.net.wasted_prefetches += 1
        if self.sanitizer is not None:
            self.sanitizer.note_spec_dispose(cid, how, True)
        return True

    def _spec_outstanding(self, box: DBox) -> bool:
        """True while ``box``'s recorded prefetch cid is still undisposed.
        A cid disposed elsewhere (a sibling's materialization, eviction,
        B.4 invalidation — paths that cannot reach the box handle) is
        cleared lazily here, so a dead cid never blocks future prefetches
        of the box."""
        if box.fetch_cid and box.fetch_cid not in self.spec_log:
            return True
        box.fetch_cid = 0
        box.fetch_server = None
        return False

    def _invalidate_prefetch(self, box: DBox) -> None:
        """The source is about to mutate / move ownership / dealloc while a
        speculative fetch of it is outstanding and unused: kill the whole
        doorbell's speculative entries (the bytes may go stale) and record
        the cid as wasted.  No-op when nothing undisposed is in flight."""
        cid = box.fetch_cid
        srv = box.fetch_server
        box.fetch_cid = 0
        box.fetch_server = None
        if not cid or cid in self.spec_log:
            return
        if srv is not None:
            self.caches[srv].invalidate_cid(cid)
        self._dispose_spec(cid, "invalidated")

    def _touch_spec(self, th, H: LocalCache, colored_g: int, e,
                    owner: DBox | None) -> None:
        """First materialized use of a cache entry: if it is speculative,
        run the deferred completion-id fence (a *late* fence — the latency
        the prefetch hid) and promote it to a regular warm copy.  The
        fence is unconditional: a sibling entry of an already-disposed
        doorbell must still wait for the READ's completion time (the
        retired-cid record keeps it); only the disposition/counter is
        once-per-cid."""
        if not e.speculative:
            return
        self._dispose_spec(e.cid, "fenced")
        self.sim.wb.fence(th, e.cid)
        H.materialize(colored_g)
        if owner is not None and owner.fetch_cid == e.cid:
            owner.fetch_cid = 0
            owner.fetch_server = None

    def prefetch(self, th, boxes) -> int:
        """Speculative fetch (§4.2 follow-on): post one read doorbell per
        cold remote box (its whole TBox group coalesced, like ``_copy_in``)
        *without* waiting — the poster pays only the issue cost.  The
        completion id is recorded on the box and on the speculative cache
        entries; the fence is deferred to the first materialized use
        (``Ref.deref`` / ``owner_read`` / ``read_many`` hit).  Ownership
        transfer, ``drop_box``, B.4 dealloc, and owner mutation fence or
        invalidate in-flight prefetches exactly like write-backs.  No
        borrow is taken — that is what makes the fetch speculative, and
        why a pre-use mutation wastes it instead of blocking.

        Returns the number of doorbells posted.  Boxes that are local,
        already cached, already in flight, mutably borrowed, or dropped
        are skipped."""
        if not self.batch_io:
            return 0                     # naive plane: no speculation
        H = self.caches[th.server]
        posted = 0
        for b in boxes:
            if (b.dropped or b.live_mut or self._spec_outstanding(b)
                    or A.server_of(b.g) == th.server
                    or b.g in H.entries):
                continue
            raw = A.clear_color(b.g)
            if not self.heap.contains(raw):
                continue
            src = A.server_of(raw)
            members = []
            for a in self._group(raw):
                if A.server_of(a) != src:
                    continue     # member moved off the root's server (its
                    #              own deref/prefetch fetches it from there)
                key = (b.g if a == raw
                       else A.append_color(a, self.obj_color.get(a, 0)))
                if key not in H.entries:
                    members.append((a, key))
            if not members:
                continue
            total = sum(self.heap.get(a).size for a, _ in members)
            cid = self.sim.wb.post_read(th, src, total,
                                        n_verbs=len(members))
            part = self.heap.partitions[th.server]
            for a, key in members:
                obj = self.heap.get(a)
                local = part.alloc(obj.size, _clone(obj.data))
                self.sim.busy(th, self.sim.cost.alloc_us)
                H.insert(key, local, refcount=0, speculative=True, cid=cid)
                # Every fetched member records the cid — a mutation of a
                # tied *child* before first use must waste the whole
                # doorbell, not just a root-recorded one.
                owner = self.owner_of.get(a)
                if owner is not None:
                    owner.fetch_cid = cid
                    owner.fetch_server = th.server
            self.spec_cids.append(cid)
            if self.sanitizer is not None:
                self.sanitizer.note_spec(th, cid)
            posted += 1
        return posted

    def _coalesce_conflict(self, box: DBox) -> None:
        """A mutable op / transfer / drop is about to touch ``box``: any
        *registered-but-unflushed* derefs hold immutable borrows on it —
        close those threads' quanta first (flush their coalesced fetch)."""
        if self.coalescer is not None:
            self.coalescer.flush_box(box)

    def _group(self, raw: int) -> list[int]:
        return self.heap.tie_closure(raw)

    def _relocate_tie_links(self, old_raw: int, new_raw: int,
                            moved: dict[int, int] | None = None) -> None:
        """An object changed address: keep the tie graph consistent — the
        parent's ``ties`` entry, the reverse ``tie_parent`` index, and the
        children's back-links.  ``moved`` maps every old→new address of a
        group move (in-group parents are rewritten by their own call)."""
        parent = self.tie_parent.pop(old_raw, None)
        if parent is not None:
            in_group = moved is not None and parent in moved
            parent_now = moved[parent] if in_group else parent
            self.tie_parent[new_raw] = parent_now
            if not in_group and self.heap.contains(parent_now):
                ties = self.heap.get(parent_now).ties
                for i, t in enumerate(ties):
                    if t == old_raw:
                        ties[i] = new_raw
        if self.heap.contains(new_raw):
            for child in self.heap.get(new_raw).ties:
                if child in self.tie_parent:
                    self.tie_parent[child] = new_raw

    def _unlink_tie(self, raw: int, freed: set[int] | None = None) -> None:
        """An object was freed: drop its reverse link and, if its tie parent
        survives, remove the dangling forward edge."""
        parent = self.tie_parent.pop(raw, None)
        if parent is not None and (freed is None or parent not in freed) \
                and self.heap.contains(parent):
            ties = self.heap.get(parent).ties
            if raw in ties:
                ties.remove(raw)

    def _copy_in(self, th, colored_g: int, batch=None) -> int:
        """COPY: fetch object (+ TBox group) into the local cache; returns the
        local copy address of the root.  The group's N members are N coalesced
        verbs behind ONE doorbell (§4.1.3); with a caller-provided ``batch``
        the verbs join a larger doorbell committed by the caller."""
        raw = A.clear_color(colored_g)
        group = self._group(raw)
        own = batch is None
        if own and self.batch_io:
            batch = self.sim.batch()
        if batch is not None:
            for a in group:
                batch.add_read(A.server_of(a), self.heap.get(a).size)
        else:                            # naive plane: one READ verb per object
            for a in group:
                self.sim.rdma_read(th, A.server_of(a), self.heap.get(a).size)
        H = self.caches[th.server]
        part = self.heap.partitions[th.server]
        root_local = A.NULL
        for a in group:
            obj = self.heap.get(a)
            local = part.alloc(obj.size, _clone(obj.data))
            self.sim.busy(th, self.sim.cost.alloc_us)
            if a == raw:
                root_local = local
            else:
                H.insert(A.append_color(a, self.obj_color.get(a, 0)), local,
                         refcount=0)
        if own and batch is not None:
            batch.commit(th)
        return root_local

    def _move_in(self, th, colored_g: int) -> int:
        """MOVE: relocate object (+ group) into the caller's partition.
        Copy over the wire, then *async* dealloc at the source; the address
        change implicitly invalidates every cached copy."""
        raw = A.clear_color(colored_g)
        src = A.server_of(raw)
        group = self._group(raw)
        total = sum(self.heap.get(a).size for a in group)
        if self.batch_io:
            batch = self.sim.batch()
            for a in group:
                batch.add_read(A.server_of(a), self.heap.get(a).size)
            batch.commit(th)
        else:                            # naive plane: one READ verb per object
            for a in group:
                self.sim.rdma_read(th, A.server_of(a), self.heap.get(a).size)
        part = self.heap.partitions[th.server]
        remap: dict[int, int] = {}
        for a in group:
            obj = self.heap.get(a)
            remap[a] = part.alloc(obj.size, obj.data)
            self.sim.busy(th, self.sim.cost.alloc_us)
        for a in group:
            old = self.heap.get(a)
            new_obj = self.heap.get(remap[a])
            new_obj.ties = [remap.get(t, t) for t in old.ties]
        for a in group:
            self.heap.free(a)
            # the data no longer lives at `a`: FT state keyed by the old
            # address must follow the object, or a later crash of the source
            # server would "restore" a stale replica at a freed (possibly
            # reused) address
            self.on_move(a, remap[a])
            owner = self.owner_of.pop(a, None)
            color = self.obj_color.pop(a, 0)
            self.owner_of[remap[a]] = owner
            self.obj_color[remap[a]] = color
            self._relocate_tie_links(a, remap[a], moved=remap)
            if owner is not None:
                owner.site = None      # the payload relocated: no override
            if owner is not None and a != raw:
                owner.g = A.append_color(remap[a], A.get_color(owner.g))
                # The move's B.4 invalidation frees every cached copy of
                # the old address — a child owner's read-path pin (set by
                # owner_read) would dangle; the root's l is reset by the
                # caller (owner_write / DropMutRef).
                owner.l = A.NULL
        if self.batch_io:
            self.sim.async_msg(src, 16 * len(group))     # coalesced dealloc req
        else:
            for _ in group:
                self.sim.async_msg(src, 16)              # naive: one per object
        self._async_invalidate_many(group)
        th.local_heap_bytes += total
        return remap[raw]

    def _move_local(self, th, colored_g: int) -> int:
        """Move-on-overflow: relocate within the local partition, color→0."""
        raw = A.clear_color(colored_g)
        part = self.heap.partitions[th.server]
        obj = part.get(raw)
        new_raw = part.alloc(obj.size, obj.data)
        new_obj = part.get(new_raw)
        new_obj.ties = list(obj.ties)
        part.free(raw)
        self.on_move(raw, new_raw)  # FT state must not outlive the address
        owner = self.owner_of.pop(raw, None)
        if owner is not None:
            owner.site = None
        self.owner_of[new_raw] = owner
        self.obj_color.pop(raw, None)
        self.obj_color[new_raw] = 0
        self._relocate_tie_links(raw, new_raw)
        self._async_invalidate(raw)
        self.sim.busy(th, self.sim.cost.alloc_us)
        return new_raw

    def _dealloc_remote(self, th, raw: int) -> None:
        src = A.server_of(raw)
        if self.heap.contains(raw):
            self.heap.free(raw)
            self.on_free(raw)
        self.sim.async_msg(src)
        self._async_invalidate(raw)

    def _async_invalidate(self, raw: int) -> None:
        """Dealloc-time cache scrub (B.4) — async, off the critical path."""
        self._async_invalidate_many((raw,))

    def _async_invalidate_many(self, raws) -> None:
        """Coalesced B.4 scrub: ONE async message per cache server covers
        every dropped address (O(1) per address via the cache's raw index).
        The naive plane sends one scrub message per (address, server) hit."""
        for s, H in enumerate(self.caches):
            n = 0
            msgs = 0
            for raw in raws:
                hit = H.invalidate_raw(raw)
                n += hit
                msgs += 1 if hit else 0
            if n:
                self.sim.net.invalidations += n
                if self.batch_io:
                    self.sim.async_msg(s, 16 * msgs)     # one msg, all addrs
                else:
                    for _ in range(msgs):
                        self.sim.async_msg(s, 16)

    def _mirror_color(self, colored_g: int) -> None:
        self.obj_color[A.clear_color(colored_g)] = A.get_color(colored_g)

    # ---- batched reads ------------------------------------------------------
    def read_many(self, th, boxes) -> list:
        """Batched immutable read of N owners: every cold miss (and its TBox
        group) joins ONE IOBatch — one doorbell per source server — instead
        of N independent READ verbs.  The cache/heap end state is identical
        to N sequential ``read`` calls (same entries, refcounts, payloads),
        so the coherence lemmas (Appendix C) are untouched; only the cost
        accounting coalesces."""
        sim = self.sim
        refs = [b.borrow(th) for b in boxes]
        try:                             # refs drop even if a deref raises
            if not self.batch_io:        # naive plane: N independent derefs
                return [r.deref(th) for r in refs]
            H = self.caches[th.server]
            batch = sim.batch()
            vals = []
            for r in refs:
                sim.deref_check(th)
                if A.server_of(r.g) == th.server:
                    sim.local_access(th)
                    vals.append(self.heap.get(A.clear_color(r.g)).data)
                    continue
                if r.l == A.NULL:
                    sim.busy(th, sim.cost.hashmap_us)
                    e = H.lookup(r.g)
                    if e is not None:
                        self._touch_spec(th, H, r.g, e, r.owner)
                        r.l = e.local
                        e.refcount += 1
                    else:
                        r.l = self._copy_in(th, r.g, batch)
                        H.insert(r.g, r.l, refcount=1)
                sim.local_access(th)
                vals.append(self.heap.get(r.l).data)
            batch.commit(th)
            return vals
        finally:
            for r in refs:
                r.drop(th)

    # ---- memory pressure (§4.2.1) -------------------------------------------
    def evict_caches(self, server: int, target_bytes: int | None = None) -> int:
        """Reclaim unpinned cache copies: full sweep by default, CLOCK
        second-chance partial eviction when ``target_bytes`` is given."""
        if target_bytes is None:
            return self.caches[server].evict_unreferenced()
        return self.caches[server].evict_clock(target_bytes)

    def frac_used(self, server: int) -> float:
        return self.heap.partitions[server].frac_used


class DrustBackend:
    """Deprecated alias kept for import compatibility: ``DrustRuntime``
    itself implements the ``ProtocolBackend`` verb surface now.  This shim
    just forwards every attribute to the runtime."""

    name = "drust"

    def __init__(self, rt: DrustRuntime):
        self.rt = rt

    def __getattr__(self, attr: str) -> Any:
        return getattr(self.rt, attr)
