"""Baseline DSM protocols the paper evaluates against (§7).

* ``GamBackend`` — a GAM-style **directory-based** protocol [Cai et al.,
  VLDB'18]: every 512 B cache block has a home node that tracks its state
  (Shared / Modified / Invalid) and its sharer set.  Reads miss to the home
  (and possibly bounce to the current owner); writes must invalidate every
  sharer before the requester is granted Modified.  Calibrated to the paper's
  §3 breakdown: a cold 512 B read costs ~16 us of which only ~3.6 us is data
  movement (77% coherence overhead).

* ``GrappaBackend`` — a Grappa-style **delegation** protocol [Nelson et al.,
  ATC'15]: there are no caches at all; every access is an RPC executed by the
  home core of the object.  Cheap to reason about, but every op pays a round
  trip and hot objects saturate their home server (the paper's KV-store skew
  collapse).

Both implement the same ``ProtocolBackend`` ABC as ``DrustRuntime``
(verbs: alloc / read / write / update / transfer / drop / read_many /
prefetch), and their handles carry the same scoped-guard surface
(``with h.read(th) as v:`` / ``with h.write(th) as w:``), so the four
applications run unmodified on all three.  Borrow misuse raises
``BorrowError`` here too — tracked by the guard layer, since neither
protocol has ownership state of its own.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from . import addr as A
from .heap import GlobalHeap
from .net import Sim
from .ownership import _clone
from .protocol import (ProtocolBackend, ReadGuard, WriteGuard,
                       register_backend)

BLOCK = 512                      # GAM default cache block size (bytes)


@dataclass
class GHandle:
    """A plain global pointer: raw address + object size."""
    raw: int
    size: int
    backend: Any = field(default=None, repr=False, compare=False)
    live_refs: int = field(default=0, repr=False, compare=False)
    live_mut: bool = field(default=False, repr=False, compare=False)

    @property
    def home(self) -> int:
        return A.server_of(self.raw)

    # Scoped-guard surface (same shape as DBox.read/DBox.write).
    def read(self, th) -> ReadGuard:
        return ReadGuard(self.backend, th, self)

    def write(self, th) -> WriteGuard:
        return WriteGuard(self.backend, th, self)


# --------------------------------------------------------------------------
#  GAM-style directory protocol
# --------------------------------------------------------------------------
@dataclass
class DirEntry:
    state: str = "S"                       # S | M
    sharers: set[int] = field(default_factory=set)
    owner: int | None = None               # server holding M


@register_backend
class GamBackend(ProtocolBackend):
    name = "gam"
    # Calibration: cold clean read = base + transfer ~= 16us @ 512B (paper §3).
    COLD_READ_BASE_US = 12.4
    LOCAL_HIT_US = 0.30                    # cached-block access incl. state check
    INV_PROC_US = 1.5                      # per-sharer invalidation handling
    PER_BLOCK_US = 0.6                     # pipelined per-512B-block directory cost

    def __init__(self, sim: Sim, heap: GlobalHeap | None = None,
                 batch_io: bool = True):
        self.sim = sim
        self.heap = heap or GlobalHeap(sim.n)
        self.batch_io = batch_io
        self.directory: dict[int, DirEntry] = {}
        # per-server block cache: raw -> payload snapshot
        self.caches: list[dict[int, Any]] = [dict() for _ in range(sim.n)]

    def alloc(self, th, size: int, data: Any = None, server: int | None = None,
              tie_to=None) -> GHandle:
        server = th.server if server is None else server
        self.sim.busy(th, self.sim.cost.alloc_us)
        if server != th.server:
            self.sim.rpc(th, server, req_bytes=64 + size)
        raw = self.heap.alloc_on(server, size, data)
        self.directory[raw] = DirEntry(state="S", sharers=set())
        return GHandle(raw, size, backend=self)

    def _nblocks(self, h: GHandle) -> int:
        return max(1, -(-h.size // BLOCK))

    def read(self, th, h: GHandle) -> Any:
        sim, d = self.sim, self.directory[h.raw]
        cache = self.caches[th.server]
        if h.home == th.server and d.state == "S":
            sim.local_access(th)
            return self.heap.get(h.raw).data
        if h.raw in cache and th.server in (d.sharers | {d.owner}):
            sim.busy(th, self.LOCAL_HIT_US)
            return cache[h.raw]
        # Cold read: request home; home may bounce to the modified owner.
        hops = 1
        if d.state == "M" and d.owner not in (th.server, None):
            hops = 2                        # home -> owner fetch & downgrade
            d.state = "S"
            d.sharers.add(d.owner)
            d.owner = None
        # wire_done: same shared-link congestion model as DRust's plane (the
        # block payload occupies the home server's link under ooo).
        base = self.COLD_READ_BASE_US * (0.6 + 0.4 * hops)
        th.t_us = (sim.wire_done(th.t_us + base, h.home, h.size)
                   + self.PER_BLOCK_US * (self._nblocks(h) - 1))
        sim.net.two_sided_msgs += 2 * hops
        sim.net.round_trips += hops
        sim.net.bytes_moved += h.size
        sim.servers[h.home].cpu_busy_us += sim.cost.dir_proc_us
        sim.servers[h.home].msgs += 1
        d.sharers.add(th.server)
        cache[h.raw] = _clone(self.heap.get(h.raw).data)
        return cache[h.raw]

    def write(self, th, h: GHandle, data: Any) -> None:
        sim, d = self.sim, self.directory[h.raw]
        if d.state == "M" and d.owner == th.server:
            sim.busy(th, self.LOCAL_HIT_US)          # write hit in Modified
            self.caches[th.server][h.raw] = data
            self.heap.get(h.raw).data = data
            return
        # Request exclusive: home invalidates every sharer, then grants M.
        sharers = d.sharers - {th.server}
        th.t_us = (sim.wire_done(th.t_us + self.COLD_READ_BASE_US, h.home,
                                 h.size)
                   + self.PER_BLOCK_US * (self._nblocks(h) - 1))
        if sharers:
            # invalidation round: parallel sends, serial ACK processing
            th.t_us += (sim.cost.two_sided_rtt_us
                        + self.INV_PROC_US * len(sharers))
        sim.net.two_sided_msgs += 2 + 2 * len(sharers)
        sim.net.round_trips += 1 + (1 if sharers else 0)
        sim.net.invalidations += len(sharers)
        sim.net.bytes_moved += h.size
        sim.servers[h.home].cpu_busy_us += (sim.cost.dir_proc_us
                                            + self.INV_PROC_US * len(sharers))
        for s in sharers:
            self.caches[s].pop(h.raw, None)
            sim.servers[s].cpu_busy_us += self.INV_PROC_US
        d.sharers = set()
        d.state, d.owner = "M", th.server
        self.caches[th.server][h.raw] = data
        self.heap.get(h.raw).data = data

    def read_many(self, th, handles) -> list:
        """Doorbell-batched reads: cold misses to the same home node share
        one directory request round (one base latency + summed transfer +
        pipelined per-block cost), keeping the comparison with DRust's
        batched plane fair.  Per-handle directory state transitions are
        identical to N sequential ``read`` calls."""
        if not self.batch_io:
            return [self.read(th, h) for h in handles]
        sim = self.sim
        vals: dict[int, Any] = {}
        cold: dict[int, list[int]] = {}          # home -> handle indices
        queued: set[int] = set()                 # raws already in this batch
        dups: list[tuple[int, int]] = []         # (index, raw) repeat fetches
        for i, h in enumerate(handles):
            d = self.directory[h.raw]
            cache = self.caches[th.server]
            if h.home == th.server and d.state == "S":
                sim.local_access(th)
                vals[i] = self.heap.get(h.raw).data
            elif h.raw in cache and th.server in (d.sharers | {d.owner}):
                sim.busy(th, self.LOCAL_HIT_US)
                vals[i] = cache[h.raw]
            elif h.raw in queued:                # duplicate: hit after fetch
                dups.append((i, h.raw))
            else:
                queued.add(h.raw)
                cold.setdefault(h.home, []).append(i)
        for home, idxs in cold.items():
            max_hops, blocks, nbytes = 1, 0, 0
            for i in idxs:
                h = handles[i]
                d = self.directory[h.raw]
                if d.state == "M" and d.owner not in (th.server, None):
                    max_hops = 2                 # bounce to the modified owner
                    d.state = "S"
                    d.sharers.add(d.owner)
                    d.owner = None
                blocks += self._nblocks(h)
                nbytes += h.size
            base = self.COLD_READ_BASE_US * (0.6 + 0.4 * max_hops)
            th.t_us = (sim.wire_done(th.t_us + base, home, nbytes)
                       + self.PER_BLOCK_US * (blocks - 1)
                       + sim.cost.doorbell_us * (len(idxs) - 1))
            sim.net.two_sided_msgs += 2 * max_hops
            sim.net.round_trips += max_hops
            sim.net.doorbell_batches += 1
            sim.net.batched_verbs += len(idxs)
            sim.net.bytes_moved += nbytes
            sim.servers[home].cpu_busy_us += (sim.cost.dir_proc_us
                                              + 0.2 * (len(idxs) - 1))
            sim.servers[home].msgs += 1
            for i in idxs:
                h = handles[i]
                self.directory[h.raw].sharers.add(th.server)
                self.caches[th.server][h.raw] = _clone(self.heap.get(h.raw).data)
                vals[i] = self.caches[th.server][h.raw]
        for i, raw in dups:                      # resolved from the warm cache
            sim.busy(th, self.LOCAL_HIT_US)
            vals[i] = self.caches[th.server][raw]
        return [vals[i] for i in range(len(handles))]

    def prefetch(self, th, handles) -> int:
        """Directory protocols have no ownership signal to make speculation
        safe — prefetch is a no-op (apps run unmodified)."""
        return 0

    # ``update`` inherits the ABC default: one write guard = read (charged
    # as a directory read) + write — exactly the legacy fn(read)+write pair.

    def drop(self, th, h: GHandle) -> None:
        self.directory.pop(h.raw, None)
        for c in self.caches:
            c.pop(h.raw, None)
        self.heap.free(h.raw)


# --------------------------------------------------------------------------
#  Grappa-style delegation protocol
# --------------------------------------------------------------------------
@register_backend
class GrappaBackend(ProtocolBackend):
    name = "grappa"
    GRAIN = 2048        # bulk accesses delegate per 2 KiB segment (no caching)

    def __init__(self, sim: Sim, heap: GlobalHeap | None = None,
                 batch_io: bool = True):
        self.sim = sim
        self.heap = heap or GlobalHeap(sim.n)
        self.batch_io = batch_io
        self._release_t: dict[int, float] = {}   # per-object home-core clock

    def alloc(self, th, size: int, data: Any = None, server: int | None = None,
              tie_to=None) -> GHandle:
        server = th.server if server is None else server
        self.sim.busy(th, self.sim.cost.alloc_us)
        if server != th.server:
            self.sim.rpc(th, server, req_bytes=64 + size)
        raw = self.heap.alloc_on(server, size, data)
        return GHandle(raw, size, backend=self)

    def _ndelegations(self, h: GHandle, nbytes: int) -> int:
        """Bulk payloads delegate per segment; small *structured* objects
        (lists: hash-table entries, id arrays) delegate per element — Grappa
        implements every global read/write as a delegated call."""
        data = self.heap.get(h.raw).data
        if isinstance(data, (list, tuple)):
            return 1 + len(data)
        return max(1, -(-nbytes // self.GRAIN))

    def _delegate(self, th, h: GHandle, nbytes_out: int, nbytes_back: int,
                  mutates: bool = False) -> None:
        sim = self.sim
        nsegs = self._ndelegations(h, max(nbytes_out, nbytes_back))
        # Hot-object serialization: *mutating* delegations for the same
        # address execute sequentially on its home core (the paper's
        # skewed-load bottleneck); the hold is the home-core service time.
        proc = sim.cost.delegation_proc_us
        if h.home == th.server:
            # Even local accesses go through the delegation queue in Grappa.
            if mutates:
                th.t_us = max(th.t_us, self._release_t.get(h.raw, 0.0))
            th.t_us += proc
            sim.servers[th.server].cpu_busy_us += proc
            sim.local_access(th)
            if mutates:
                self._release_t[h.raw] = th.t_us
        else:
            per_out = nbytes_out // nsegs
            per_back = nbytes_back // nsegs
            one_way = sim.cost.two_sided_rtt_us / 2
            for seg in range(nsegs):
                # request leg converges on (and may congest) the home's link
                arrive = sim.wire_done(th.t_us + one_way, h.home,
                                       64 + per_out)
                start = arrive
                if mutates:
                    start = max(arrive, self._release_t.get(h.raw, 0.0))
                done = start + proc
                if mutates:
                    self._release_t[h.raw] = done
                # Response leg departs after home processing — charging it to
                # the shared link would smear the home-core serialization into
                # the link's busy-until and over-delay unrelated traffic; the
                # small response rides uncongested.
                th.t_us = done + one_way + sim.cost.xfer_us(16 + per_back)
                sim.net.two_sided_msgs += 2
                sim.net.round_trips += 1
                sim.net.bytes_moved += 80 + per_out + per_back
                sim.servers[h.home].cpu_busy_us += proc
                sim.servers[h.home].msgs += 1

    def read(self, th, h: GHandle) -> Any:
        self._delegate(th, h, 0, h.size)
        return _clone(self.heap.get(h.raw).data)

    def read_many(self, th, handles) -> list:
        """Doorbell-batched delegation: read requests for the same home node
        ride one aggregated message (Grappa's own delegation aggregator);
        the home core still executes every delegated op, so hot-home CPU
        saturation is preserved — only the per-op wire round trip amortizes
        (segments stream inside the aggregate: one round trip per home, the
        same modeling choice as DRust's one-completion-per-doorbell; header
        bytes stay per-segment to match ``_delegate``'s accounting)."""
        if not self.batch_io:
            return [self.read(th, h) for h in handles]
        sim = self.sim
        vals: dict[int, Any] = {}
        by_home: dict[int, list[int]] = {}
        for i, h in enumerate(handles):
            if h.home == th.server:
                proc = sim.cost.delegation_proc_us
                th.t_us += proc
                sim.servers[th.server].cpu_busy_us += proc
                sim.local_access(th)
                vals[i] = _clone(self.heap.get(h.raw).data)
            else:
                by_home.setdefault(h.home, []).append(i)
        for home, idxs in by_home.items():
            nsegs = sum(self._ndelegations(handles[i], handles[i].size)
                        for i in idxs)
            nbytes = sum(handles[i].size for i in idxs)
            proc = sim.cost.delegation_proc_us * nsegs
            th.t_us = (sim.wire_done(th.t_us + sim.cost.two_sided_rtt_us,
                                     home, 80 * nsegs + nbytes) + proc)
            sim.net.two_sided_msgs += 2
            sim.net.round_trips += 1
            sim.net.doorbell_batches += 1
            sim.net.batched_verbs += nsegs
            sim.net.bytes_moved += 80 * nsegs + nbytes
            sim.servers[home].cpu_busy_us += proc
            sim.servers[home].msgs += 1
            for i in idxs:
                vals[i] = _clone(self.heap.get(handles[i].raw).data)
        return [vals[i] for i in range(len(handles))]

    def prefetch(self, th, handles) -> int:
        """Delegation has no caches to prefetch into — no-op."""
        return 0

    def write(self, th, h: GHandle, data: Any) -> None:
        self._delegate(th, h, h.size, 0, mutates=True)
        self.heap.get(h.raw).data = data

    def update(self, th, h: GHandle, fn: Callable[[Any], Any]) -> Any:
        # Delegation executes the closure at the home — single round trip
        # (cheaper than the generic read+write guard pair; keep the
        # override).
        self._delegate(th, h, 64, 64, mutates=True)
        obj = self.heap.get(h.raw)
        obj.data = fn(obj.data)
        return obj.data

    def drop(self, th, h: GHandle) -> None:
        self.heap.free(h.raw)
