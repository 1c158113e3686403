"""Ownership-paged KV cache: DRust's protocol applied to serving state.

Pages are heap objects under the ownership model, and — when the cache is
constructed over a ``Cluster`` — real DSM objects behind the scoped-guard
surface of ``ProtocolBackend``:

  * The request that *appends* to a page holds the scoped mutable borrow
    (``with page.box.write(th) as w:``) — the append is a local write and
    the color bump rides the DropMutRef write-back (Algorithm 6).  No
    other request can read a page mid-append, by construction.
  * Shared prefix pages are immutably borrowed by many requests: each
    decode step reads its page set through ``backend.read_many`` inside
    the engine's region, so cold remote pages coalesce into per-source
    doorbells and warm ones are zero-communication cache hits.
  * A request's *generation* pages form a TBox chain (each tail page is
    ``tie_to``-tied to its predecessor): the chain is co-located with its
    single writer, fetched as one doorbell by any remote reader, and
    freed as one coalesced drop (B.4) when the request completes.
  * Refcounts drive lazy reclamation under memory pressure (§4.2.1):
    pages with zero refs are evictable, LRU-ordered; evicting a
    DSM-backed page drops its box, which invalidates every cached copy.

The host-side page table below is the control plane; the device-side cache
is the model's slot-contiguous KV buffer.  Page size = ``attn_chunk`` so
page boundaries align with kernel blocks.  Without a cluster the cache runs
exactly as the seed local-only control plane (no boxes, no costs).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any

from repro_torch.core.torchstate import ColoredAddr
from repro_torch.core.ownership import BorrowError


@dataclass
class Page:
    addr: ColoredAddr
    tokens: tuple[int, ...]            # token ids covered by this page
    page_size: int = 0                 # capacity; 0 = unbounded
    refcount: int = 0
    mut_borrowed: bool = False
    sealed: bool = False               # immutable from here on
    last_use: int = 0
    box: Any = None                    # DSM handle when cluster-backed

    @property
    def full(self) -> bool:
        return self.page_size > 0 and len(self.tokens) >= self.page_size


class PagedKVCache:
    """Page table + prefix-sharing index for a serving cluster.

    ``cluster``/``th`` switch on the DSM plane: pages get protocol-backed
    boxes, shared prefix pages stripe across the cluster's servers, and
    every append / read / evict charges the simulator through the guard
    API.  ``bytes_per_token`` sizes a page's wire footprint.
    """

    _uid = itertools.count()

    def __init__(self, page_size: int = 1024, capacity_pages: int = 4096,
                 cluster=None, th=None, bytes_per_token: int = 256,
                 stripe: bool = True):
        self.page_size = page_size
        self.capacity = capacity_pages
        self.cluster = cluster
        self.th = th
        self.bytes_per_token = bytes_per_token
        self.stripe = stripe
        self.pages: dict[str, Page] = {}          # addr.name -> Page
        self.prefix_index: dict[tuple, str] = {}  # token tuple -> addr.name
        self.clock = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._stripe_rr = 0

    def _th(self, th):
        return th if th is not None else self.th

    # -- allocation / append (mutable path) --------------------------------
    def alloc_page(self, tokens: tuple[int, ...], th=None,
                   tie_to: Page | None = None, local: bool = False) -> Page:
        """Allocate a page frame (evicting under pressure).

        DSM plane: ``tie_to`` chains the page into its predecessor's TBox
        group (co-located, group-fetched, group-dropped); ``local`` pins
        the frame to the allocating thread's server (single-writer append
        pages live with their writer), otherwise shared prefix frames
        stripe round-robin across servers.
        """
        tokens = tuple(tokens)
        if self.page_size and len(tokens) > self.page_size:
            raise ValueError(
                f"page overflow: {len(tokens)} tokens > page_size "
                f"{self.page_size}")
        if len(self.pages) >= self.capacity:
            freed = self.evict(1, th=th)
            if not freed:
                raise MemoryError("KV cache full and no evictable pages")
        addr = ColoredAddr(f"page#{next(self._uid)}", 0)
        page = Page(addr, tokens, page_size=self.page_size)
        if self.cluster is not None:
            t = self._th(th)
            nbytes = max(1, self.page_size or len(tokens)) \
                * self.bytes_per_token
            if tie_to is not None and tie_to.box is not None:
                page.box = self.cluster.backend.alloc(
                    t, nbytes, tokens, tie_to=tie_to.box)
            else:
                if local or not self.stripe:
                    server = t.server
                else:
                    server = self._stripe_rr % self.cluster.sim.n
                    self._stripe_rr += 1
                page.box = self.cluster.backend.alloc(
                    t, nbytes, tokens, server=server)
        self.pages[addr.name] = page
        self.touch(page)
        return page

    def append(self, page: Page, token: int, th=None) -> Page:
        """Scoped mutable borrow: exclusive append; color bump on exit."""
        if page.sealed:
            raise BorrowError("append to a sealed (immutable) page")
        if page.full:
            raise BorrowError("append to a full page: seal it and chain a "
                              "new page (tie_to=) instead")
        if page.refcount > 1:
            raise BorrowError("append to a shared page requires copy-on-write")
        if page.mut_borrowed:
            raise BorrowError("page already mutably borrowed")
        page.mut_borrowed = True
        try:
            new_tokens = page.tokens + (token,)
            if page.box is not None:
                # The write guard IS the append epoch: enter = exclusive
                # borrow, w.set = the local store, exit = DropMutRef (the
                # colored-address write-back — the on-wire color bump).
                with page.box.write(self._th(th)) as w:
                    w.set(new_tokens)
            page.tokens = new_tokens
            page.addr = page.addr.bumped()         # the invalidation
        finally:
            page.mut_borrowed = False
        self.touch(page)
        return page

    def seal(self, page: Page) -> None:
        """The page becomes immutable and enters the prefix index (shared
        prefixes are looked up by their full token tuple)."""
        page.sealed = True
        self.prefix_index[page.tokens] = page.addr.name

    def freeze(self, page: Page) -> None:
        """Immutability without prefix-index entry — generation pages are
        request-private, so they must never be handed to other requests
        (their chain is freed as one closure at completion)."""
        page.sealed = True

    def fork(self, page: Page, th=None) -> Page:
        """Copy-on-write: a shared page that must diverge is *moved* to a
        new address for the writer (Algorithm 6 move-on-write).  The
        writer's reference migrates to its private copy: the shared page
        loses one ref, the fork is born with ``refcount == 1``."""
        new = self.alloc_page(page.tokens, th=th, local=True)
        new.refcount = 1
        self.release(page)
        return new

    # -- prefix sharing (immutable path) -------------------------------------
    def lookup_prefix(self, tokens: tuple[int, ...]) -> Page | None:
        name = self.prefix_index.get(tuple(tokens))
        if name is None:
            self.misses += 1
            return None
        page = self.pages.get(name)
        if page is None or page.tokens != tuple(tokens):
            # Stale entry: the page was evicted, or an append bumped its
            # color past this prefix — the colored address the index
            # recorded no longer names these bytes (Stale-Value-
            # Elimination, Appendix C.4).  Scrub and miss.
            self.misses += 1
            del self.prefix_index[tuple(tokens)]
            return None
        self.hits += 1
        return page

    def peek_prefix(self, tokens: tuple[int, ...]) -> Page | None:
        """Side-effect-free ``lookup_prefix`` (no hit/miss accounting, no
        scrub) — used for prefetch-window hints, which must not perturb
        the cache statistics the SLO gate pins."""
        name = self.prefix_index.get(tuple(tokens))
        if name is None:
            return None
        page = self.pages.get(name)
        if page is None or page.tokens != tuple(tokens):
            return None
        return page

    def retain(self, page: Page, th=None) -> Page:
        """A request takes a shared reference on a page for its lifetime.
        The host refcount pins the frame against eviction; the protocol
        borrows are scoped per decode step (``read_many`` inside the
        engine's region), so this never holds a wire-level borrow open."""
        if page.mut_borrowed:
            raise BorrowError("read during append epoch")
        page.refcount += 1
        self.touch(page)
        return page

    def release(self, page: Page, th=None) -> None:
        page.refcount = max(0, page.refcount - 1)

    # Seed-compat aliases (the guard-era spellings above are canonical).
    borrow = retain
    drop = release

    def touch(self, page: Page) -> None:
        self.clock += 1
        page.last_use = self.clock

    # -- reclamation ----------------------------------------------------------
    def _free_box(self, page: Page, th=None) -> None:
        if page.box is not None and not page.box.dropped:
            # Drop of the owner: coalesced dealloc + async B.4 invalidation
            # of every server's cached copy of the page.
            self.cluster.backend.free(self._th(th), page.box)
            page.box = None

    def evict(self, n: int = 1, th=None) -> int:
        """Lazy zero-refcount reclamation, LRU first (§4.2.1)."""
        victims = sorted(
            (p for p in self.pages.values() if p.refcount == 0
             and not p.mut_borrowed),
            key=lambda p: p.last_use)[:n]
        for p in victims:
            self.pages.pop(p.addr.name, None)
            self.prefix_index.pop(p.tokens, None)
            self._free_box(p, th=th)
            self.evictions += 1
        return len(victims)

    def reclaim_chain(self, pages: list[Page], th=None) -> None:
        """Free a request's private generation chain: one owner drop on the
        chain root frees the whole TBox closure (coalesced dealloc, one
        async message per remote server), then the host frames go."""
        for p in pages:
            p.refcount = 0
        if pages and pages[0].box is not None:
            # The chain is tied root->...->tail: dropping the root's box
            # walks the tie closure and frees every member's slot.
            self._free_box(pages[0], th=th)
            for p in pages[1:]:
                p.box = None
        for p in pages:
            self.pages.pop(p.addr.name, None)
            self.prefix_index.pop(p.tokens, None)

    @property
    def bytes_estimate(self) -> int:
        return len(self.pages) * self.page_size * self.bytes_per_token

    def stats(self) -> dict:
        return {"pages": len(self.pages), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "shared": sum(1 for p in self.pages.values()
                              if p.refcount > 1)}
