"""Per-server read-only cache: the hashmap H of Algorithms 2/4/7.

Maps a *colored* global address to (local copy address, live-ref count).
Copies live in the server's regular heap partition (the cache is a "virtual"
aggregation, §4.1.1); entries with refcount 0 are reclaimed lazily under
memory pressure.  Because keys are colored, any write (which bumps the color
or moves the object) makes stale entries unreachable — they age out without
any invalidation message.

Indexing
--------
Two structures keep every hot-path operation O(1) amortized:

* ``_by_raw`` — secondary index from the *uncolored* raw address to the set
  of colored keys currently caching it, so dealloc-time invalidation
  (``invalidate_raw``, Appendix B.4) touches only matching entries instead
  of scanning the whole map.
* ``bytes_cached`` — a counter maintained on insert/remove/invalidate/evict
  (it used to be a full scan summing partition sizes).
* ``_by_cid`` — speculative-prefetch index from a prefetch doorbell's
  completion id to the colored keys it fetched, so a transfer/mutation
  before first use invalidates exactly that doorbell's entries
  (``invalidate_cid``) in O(1).  A speculative entry that leaves the cache
  any other way (eviction, B.4 invalidation, insert-replace) fires the
  ``on_spec_drop`` hook so the runtime can record the cid as wasted.

Eviction under memory pressure is CLOCK-style second chance: ``lookup`` sets
a reference bit, ``evict_clock`` sweeps a persistent hand, giving recently
hit entries one more pass before their copies are freed.  Pinned entries
(refcount > 0) are never evicted.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import addr as A
from .heap import Partition


@dataclass
class CacheEntry:
    local: int          # raw address of the copy in the local partition
    refcount: int
    size: int = 0       # copy size, captured at insert (for bytes_cached)
    ref_bit: bool = True  # CLOCK second-chance bit
    speculative: bool = False  # prefetched, completion fence still deferred
    cid: int = 0        # completion id of the speculative fetch doorbell
    suspect: bool = False  # home server failed while this copy was pinned:
    #   the frozen snapshot keeps serving its open ReadGuards, but new
    #   lookups MISS (they must re-fetch the restored epoch value) and the
    #   copy is freed the moment the last pin drops


class LocalCache:
    def __init__(self, server: int, partition: Partition):
        self.server = server
        self.partition = partition
        self.entries: dict[int, CacheEntry] = {}   # colored g -> entry
        self._by_raw: dict[int, set[int]] = {}     # raw -> colored keys
        self._by_cid: dict[int, set[int]] = {}     # spec cid -> colored keys
        self._bytes = 0
        self._hand = 0                             # CLOCK hand (key index)
        # colored g -> [local, pins]: suspect entries displaced by a
        # re-fetch while still pinned (see ``insert``); freed at pins==0
        self._limbo: dict[int, list[int]] = {}
        self.hits = 0
        self.misses = 0
        # Runtime hook: a *speculative* entry left the cache without being
        # materialized (evicted / B.4-invalidated) — the runtime records the
        # cid's disposition so every speculative fetch is fenced or
        # invalidated exactly once.
        self.on_spec_drop = lambda cid: None

    def lookup(self, colored_g: int) -> CacheEntry | None:
        e = self.entries.get(colored_g)
        if e is not None and not e.suspect:
            self.hits += 1
            e.ref_bit = True
            return e
        # A suspect entry is invisible to new readers: its bytes may hold a
        # write that died unflushed with the home server, and serving them
        # would resurrect it.  Open pins keep their frozen snapshot through
        # the direct local address; everyone else misses and re-fetches.
        self.misses += 1
        return None

    def insert(self, colored_g: int, local_raw: int, refcount: int = 1,
               speculative: bool = False, cid: int = 0) -> CacheEntry:
        size = (self.partition.get(local_raw).size
                if self.partition.contains(local_raw) else 0)
        old = self.entries.get(colored_g)
        if old is not None:
            self._drop_index(colored_g, old)
            if old.suspect and old.refcount > 0:
                # A new reader re-fetched past a still-pinned suspect copy:
                # the frozen snapshot must outlive the key collision, so it
                # parks in limbo until its pins drain (``dec`` drains limbo
                # first — the pre-crash pins are the ones that drop next).
                lim = self._limbo.get(colored_g)
                if lim is None:
                    self._limbo[colored_g] = [old.local, old.refcount]
                else:
                    lim[1] += old.refcount
            elif old.suspect:
                self._free_copy(old)
        e = CacheEntry(local_raw, refcount, size=size,
                       speculative=speculative, cid=cid)
        self.entries[colored_g] = e
        self._by_raw.setdefault(A.clear_color(colored_g), set()).add(colored_g)
        if speculative:
            self._by_cid.setdefault(cid, set()).add(colored_g)
        self._bytes += size
        return e

    def materialize(self, colored_g: int) -> None:
        """First materialized use of a speculative entry: the completion
        fence ran — the entry becomes a regular warm copy."""
        e = self.entries.get(colored_g)
        if e is None or not e.speculative:
            return
        e.speculative = False
        keys = self._by_cid.get(e.cid)
        if keys is not None:
            keys.discard(colored_g)
            if not keys:
                del self._by_cid[e.cid]

    def invalidate_cid(self, cid: int) -> int:
        """Kill every still-speculative entry of a prefetch doorbell (the
        source moved ownership / mutated before first use).  Returns the
        number of entries dropped.  Does NOT fire ``on_spec_drop`` — the
        caller is the runtime, already recording the disposition."""
        victims = self._by_cid.pop(cid, None)
        if not victims:
            return 0
        n = 0
        for g in victims:
            e = self.entries.pop(g, None)
            if e is None:
                continue
            raw_keys = self._by_raw.get(A.clear_color(g))
            if raw_keys is not None:
                raw_keys.discard(g)
                if not raw_keys:
                    del self._by_raw[A.clear_color(g)]
            self._bytes -= e.size
            self._free_copy(e)
            n += 1
        return n

    def inc(self, colored_g: int) -> CacheEntry:
        e = self.entries[colored_g]
        e.refcount += 1
        return e

    def dec(self, colored_g: int) -> None:
        lim = self._limbo.get(colored_g)
        if lim is not None:              # a displaced frozen snapshot drains
            lim[1] -= 1
            if lim[1] <= 0:
                del self._limbo[colored_g]
                if self.partition.contains(lim[0]):
                    self.partition.free(lim[0])
            return
        e = self.entries.get(colored_g)
        if e is not None and e.refcount > 0:
            e.refcount -= 1
            if e.refcount == 0 and e.suspect:
                # last pin of a crash-frozen snapshot dropped: the copy is
                # both stale (pre-crash bytes) and unreachable (lookup
                # misses) — free it now instead of waiting for pressure
                self.entries.pop(colored_g, None)
                self._drop_index(colored_g, e)
                self._free_copy(e)

    def remove(self, colored_g: int) -> CacheEntry | None:
        e = self.entries.pop(colored_g, None)
        if e is not None:
            self._drop_index(colored_g, e)
        return e

    def _drop_index(self, colored_g: int, e: CacheEntry) -> None:
        raw = A.clear_color(colored_g)
        keys = self._by_raw.get(raw)
        if keys is not None:
            keys.discard(colored_g)
            if not keys:
                del self._by_raw[raw]
        self._bytes -= e.size
        if e.speculative:
            cids = self._by_cid.get(e.cid)
            if cids is not None:
                cids.discard(colored_g)
                if not cids:
                    del self._by_cid[e.cid]
            self.on_spec_drop(e.cid)

    def _free_copy(self, e: CacheEntry) -> int:
        if self.partition.contains(e.local):
            freed = self.partition.get(e.local).size
            self.partition.free(e.local)
            return freed
        return 0

    def invalidate_raw(self, raw: int) -> int:
        """Async invalidation on dealloc/move (Appendix B.4): drop every entry
        whose underlying raw address matches, freeing the local copies.
        O(1) amortized via the raw index (was a full-map scan)."""
        victims = self._by_raw.pop(raw, None)
        if not victims:
            return 0
        n = 0
        for g in victims:
            e = self.entries.pop(g, None)
            if e is None:
                continue
            self._bytes -= e.size
            if e.speculative:
                cids = self._by_cid.get(e.cid)
                if cids is not None:
                    cids.discard(g)
                    if not cids:
                        del self._by_cid[e.cid]
                self.on_spec_drop(e.cid)
            self._free_copy(e)
            n += 1
        return n

    def quarantine_home(self, home: int) -> tuple[int, int]:
        """The home server of some cached objects failed: copies of its
        boxes may hold writes that died unflushed (the restored replica
        reverts to the last flushed epoch), so serving them would silently
        resurrect lost writes.  Unpinned copies are invalidated on the
        spot; pinned copies (open ``ReadGuard``s — frozen snapshots by
        contract) are marked *suspect*: they keep serving their holders but
        are invisible to new lookups and are freed when the last pin drops.
        Returns ``(invalidated, suspected)`` entry counts."""
        victims = [(g, e) for g, e in self.entries.items()
                   if A.server_of(A.clear_color(g)) == home]
        invalidated = suspected = 0
        for g, e in victims:
            if e.refcount > 0:
                e.suspect = True
                suspected += 1
            else:
                self.entries.pop(g, None)
                self._drop_index(g, e)       # spec entries fire on_spec_drop
                self._free_copy(e)
                invalidated += 1
        return invalidated, suspected

    def drop_all(self) -> int:
        """The cache's own server died: every entry is gone with it.  Fires
        ``on_spec_drop`` for still-speculative entries (their prefetch cids
        get an ``invalidated`` disposition) but does not touch the backing
        partition — the crash already cleared it."""
        n = len(self.entries)
        for g, e in list(self.entries.items()):
            self._drop_index(g, e)
        self.entries.clear()
        self._by_raw.clear()
        self._by_cid.clear()
        self._limbo.clear()
        self._bytes = 0
        return n

    def evict_unreferenced(self) -> int:
        """Lazy reclamation under memory pressure (§4.2.1): free every
        unpinned copy.  Returns bytes freed."""
        victims = [g for g, e in self.entries.items() if e.refcount <= 0]
        freed = 0
        for g in victims:
            e = self.entries.pop(g)
            self._drop_index(g, e)
            freed += self._free_copy(e)
        return freed

    def evict_clock(self, target_bytes: int) -> int:
        """CLOCK second-chance eviction: free unpinned copies until at least
        ``target_bytes`` are reclaimed (or every candidate had its chance).
        Entries hit since the last sweep survive one extra pass."""
        freed = 0
        keys = list(self.entries)
        if not keys:
            return 0
        scans = 0
        limit = 2 * len(keys)
        while freed < target_bytes and scans < limit:
            self._hand %= len(keys)
            g = keys[self._hand]
            scans += 1
            e = self.entries.get(g)
            if e is None or e.refcount > 0:
                self._hand += 1
                continue
            if e.ref_bit:
                e.ref_bit = False
                self._hand += 1
                continue
            self.entries.pop(g)
            self._drop_index(g, e)
            freed += self._free_copy(e)
            self._hand += 1
        return freed

    @property
    def bytes_cached(self) -> int:
        return self._bytes
