"""Batched serving engine over the DSM runtime: continuous batching over a
fixed slot set, the ownership-paged KV cache for prefix sharing, and
zero-invalidation weight refresh — optionally compressed to int8 on the
wire (``repro_torch.dist.compression``).  The PyTorch counterpart of
``repro.serve.engine``: the control plane is carried over unchanged, and
the model step runs on the engine's ``device`` (``cuda`` unless the caller
passes ``device="cpu"``).

Two planes, one token path:

  * **Local (seed) plane** — ``ServeEngine(cfg, weights)`` with no
    ``cluster``: pure host bookkeeping, exactly the seed engine.
  * **DSM plane** — ``ServeEngine(..., cluster=cl)``: every decode tick
    runs inside ``with cluster.region(th, prefetch=next_window)`` — the
    region scope is the tick's borrow lifetime, the prefetch hint posts
    speculative read doorbells for the *next* decode window (the kvstore
    ``prefetch_window`` pattern generalized to serving), and region exit
    is the settle point.  Page reads go through ``backend.read_many``
    (per-source doorbells, warm hits free), appends through scoped write
    guards (local write + color-bump write-back), and weight refreshes
    ride the colored ``StateCache`` — zero communication when the color
    matches, int8 over the wire when it doesn't.

The DSM plane never touches token *values*: admission order, slot
assignment, truncation, and the decode function are identical on both
planes, so ``digest()`` is byte-identical at every cluster size — the
protocol layer moves costs, not results (the equivalence gate in
``tests/test_serve_dsm.py`` pins this at 1/2/4/8 servers).

``step_fn`` swaps the model step for any
``(params, cache, tokens[B,1]) -> (next[B,1], cache)`` callable — the
load benches use a deterministic stub so the SLO trajectory in
``BENCH_protocol.json`` is virtual-clock-only.  ``ServeFleet`` runs one
engine replica per server over a shared page table: prefix pages are
fetched remotely once and then serve from each replica's local cache —
the read-mostly sharing the protocol optimizes.
"""

from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.torchstate import OwnedState, StateCache
from .kvcache import Page, PagedKVCache


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    generated: list[int] = field(default_factory=list)
    done: bool = False
    pages: list = field(default_factory=list)   # shared prefix pages (retained)
    tail_pages: list = field(default_factory=list)  # private generation chain
    t_arrive: float = 0.0                       # virtual us (open-loop traces)
    t_done: float = 0.0

    @property
    def latency_us(self) -> float:
        return self.t_done - self.t_arrive


class ServeEngine:
    """One model replica: continuous batching over ``slots`` decode lanes.

    ``cluster``/``server`` place the replica's thread; ``wire`` selects the
    weight-refresh encoding (``"int8"`` quantizes each refresh via
    ``repro_torch.dist.compression`` — 4x fewer bytes, documented-lossy;
    ``"raw"`` ships exact bytes); ``weights_server`` is where the trainer
    publishes (refreshes are remote reads unless it matches ``server``);
    ``decode_cycles`` is the per-tick compute charged to the virtual
    clock; ``prefetch_window`` is how many queued requests ahead the
    region entry hint covers; ``kv`` shares a fleet-wide page table;
    ``device`` is where the real model's cache and tokens live (the
    weights must already be there); ``mesh`` (a ``DeviceMesh``) runs the
    model step on it: every rank runs the engine in lockstep on the same
    requests and replicated weights, and the step's collectives (the
    sharded decode of a ``decode_shard_s`` model, the MoE's expert
    parallelism) keep the ranks together.
    """

    def __init__(self, cfg=None, weights: OwnedState | None = None,
                 slots: int = 4, max_len: int | None = None, mesh=None,
                 cluster=None, server: int = 0, wire: str = "raw",
                 weights_server: int = 0, step_fn=None,
                 decode_cycles: float = 4000.0, prefetch_window: int = 1,
                 page_size: int | None = None, vocab: int | None = None,
                 kv: PagedKVCache | None = None, device="cuda"):
        if cfg is None and (step_fn is None or page_size is None):
            raise ValueError("cfg-less engines need step_fn and page_size")
        self.cfg = cfg
        self.weights = weights
        self.slots = slots
        self.max_len = max_len or (cfg.max_target_len if cfg else 1 << 30)
        self.mesh = mesh
        self.cluster = cluster
        self.wire = wire
        self.weights_server = weights_server
        self.decode_cycles = decode_cycles
        self.prefetch_window = prefetch_window
        self.vocab = vocab or (cfg.vocab if cfg else 0)
        self.th = cluster.main_thread(server) if cluster is not None else None
        self.wire_bytes = 0
        self.weight_cache = StateCache(transfer=self._wire_transfer)
        ps = page_size or cfg.attn_chunk
        self.kv = kv if kv is not None else PagedKVCache(
            page_size=ps, cluster=cluster, th=self.th)
        self.device = None
        if step_fn is not None:
            self._step = step_fn
            self.cache = None
        else:
            from repro_torch.models import init_cache
            from repro_torch.models.transformer import resolve_device
            from .serve_step import make_serve_step
            self.device = resolve_device(device)
            # the step updates this cache in place (the reference donates it)
            self._step = make_serve_step(cfg, mesh=mesh)
            self.cache = init_cache(cfg, slots, self.max_len,
                                    device=self.device, mesh=mesh)
        self.active: dict[int, Request] = {}        # slot -> request
        self._t_us = 0.0                            # local-plane clock
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.steps = 0
        self._rid = itertools.count()

    # -- virtual clock ------------------------------------------------------
    def now_us(self) -> float:
        return self.th.t_us if self.th is not None else self._t_us

    def advance_to(self, t_us: float) -> None:
        """Idle until ``t_us`` (open-loop driver: next arrival is in the
        future and no work is in flight).  The local plane keeps its own
        arrival-driven clock — decode there is costless, but time must
        still move or an open-loop replay would never drain its trace."""
        if self.th is not None:
            self.th.t_us = max(self.th.t_us, t_us)
        else:
            self._t_us = max(self._t_us, t_us)

    # -- client API ---------------------------------------------------------
    def submit(self, prompt: list[int], max_new: int = 16,
               t_arrive: float | None = None,
               rid: int | None = None) -> Request:
        """Queue a request (continuous batching admits it when a slot
        frees).  Prompts that cannot fit ``max_len`` alongside their
        ``max_new`` budget are head-truncated — deterministically, and
        identically on both planes."""
        prompt = list(prompt)
        budget = self.max_len - max_new
        if budget <= 0:
            raise ValueError(f"max_new {max_new} exceeds max_len "
                             f"{self.max_len}")
        if len(prompt) > budget:
            prompt = prompt[-budget:]              # keep the recent context
        req = Request(next(self._rid) if rid is None else rid,
                      prompt, max_new,
                      t_arrive=self.now_us() if t_arrive is None
                      else t_arrive)
        self.queue.append(req)
        return req

    # -- admission (continuous batching) ------------------------------------
    def _prefix_spans(self, prompt: list[int]):
        ps = self.kv.page_size
        for i in range(0, max(0, len(prompt) - ps + 1), ps):
            yield tuple(prompt[i:i + ps])

    def _admit(self):
        for slot in range(self.slots):
            if slot in self.active or not self.queue:
                continue
            req = self.queue.pop(0)
            # prefix sharing: reuse sealed pages for the prompt's full pages
            for span in self._prefix_spans(req.prompt):
                page = self.kv.lookup_prefix(span)
                if page is None:
                    page = self.kv.alloc_page(span, th=self.th)
                    self.kv.seal(page)
                req.pages.append(self.kv.retain(page, th=self.th))
            # private single-writer tail chain for the generated tokens
            tail = self.kv.alloc_page((), th=self.th, local=True)
            req.tail_pages.append(self.kv.retain(tail, th=self.th))
            self.active[slot] = req

    # -- weight refresh ------------------------------------------------------
    def _wire_transfer(self, tree):
        """StateCache miss: the refresh crosses the wire.  ``int8`` packs
        every large float leaf (|err| <= scale/2) and ships 4x fewer
        bytes; the cost lands on the replica thread as one remote read
        from the trainer's server."""
        if self.cluster is None:
            return tree
        if self.wire == "int8":
            from repro_torch.dist.compression import (dequantize_tree,
                                                      quantize_tree,
                                                      wire_bytes)
            packed = quantize_tree(tree)
            nbytes = wire_bytes(packed)
            out = dequantize_tree(packed)
        else:
            from repro_torch.dist.compression import wire_bytes
            nbytes = wire_bytes(tree)
            out = tree
        self.wire_bytes += int(nbytes)
        if self.weights_server != self.th.server:
            self.cluster.sim.rdma_read(self.th, self.weights_server,
                                       int(nbytes))
        else:
            self.cluster.sim.local_access(self.th, int(nbytes))
        return out

    # -- prefetch window -----------------------------------------------------
    def _next_window(self):
        """DSM boxes the *next* decode tick will read: the active
        requests' page sets plus the existing prefix pages of the next
        ``prefetch_window`` queued requests (their admission is
        imminent).  Posted as the region's entry hint, so the fetch
        overlaps this tick's compute."""
        boxes = []
        seen = set()

        def add(page: Page):
            if page.box is not None and id(page.box) not in seen:
                seen.add(id(page.box))
                boxes.append(page.box)

        for req in self.active.values():
            for p in req.pages:
                add(p)
            for p in req.tail_pages:
                add(p)
        free = self.slots - len(self.active)
        for req in self.queue[:min(self.prefetch_window, free)]:
            for span in self._prefix_spans(req.prompt):
                page = self.kv.peek_prefix(span)
                if page is not None:
                    add(page)
        return boxes

    # -- one decode tick across all active slots ------------------------------
    def step(self) -> int:
        """One tick: admission, then the decode of every active slot.
        While the profiler runs it is the span ``repro_torch/tick``, with
        ``admit``, ``read_pages`` and ``decode`` inside."""
        with telemetry.span("repro_torch/tick"):
            with telemetry.span("repro_torch/admit"):
                self._admit()
            if not self.active:
                return 0
            if self.cluster is None:
                return self._tick()
            window = self._next_window()
            with self.cluster.region(self.th, prefetch=window):
                return self._tick()

    def _read_pages(self):
        """Attention reads every page of every active sequence: one
        ``read_many`` per tick coalesces the cold misses into per-source
        doorbells; warm pages are local hashmap hits."""
        boxes, seen = [], set()
        for req in self.active.values():
            for p in req.pages + req.tail_pages:
                if p.box is not None and id(p.box) not in seen:
                    seen.add(id(p.box))
                    boxes.append(p.box)
        if boxes:
            self.cluster.backend.read_many(self.th, boxes)

    def _tick(self) -> int:
        params = (self.weight_cache.fetch(self.weights)   # color-keyed
                  if self.weights is not None else None)  # refresh
        if self.cluster is not None:
            with telemetry.span("repro_torch/read_pages"):
                self._read_pages()
        tokens = np.zeros((self.slots, 1), np.int32)
        for slot, req in self.active.items():
            seq = req.prompt + req.generated
            tokens[slot, 0] = seq[-1]
        with telemetry.span("repro_torch/decode"):
            if self.device is not None:             # real model on the device
                nxt, self.cache = self._step(
                    params, self.cache,
                    torch.from_numpy(tokens).to(self.device))
                nxt = nxt.cpu().numpy()
            else:                                   # stub step: numpy
                nxt, self.cache = self._step(params, self.cache, tokens)
                nxt = np.asarray(nxt)
        if self.cluster is not None:
            self.cluster.sim.compute(self.th, self.decode_cycles)
        finished = []
        for slot, req in self.active.items():
            tok = int(nxt[slot, 0])
            req.generated.append(tok)
            tail = req.tail_pages[-1]
            if tail.full:
                self.kv.freeze(tail)               # immutable, never indexed
                tail = self.kv.alloc_page((), th=self.th, tie_to=tail,
                                          local=True)
                req.tail_pages.append(self.kv.retain(tail, th=self.th))
            self.kv.append(tail, tok, th=self.th)  # write guard: color bump
            if len(req.generated) >= req.max_new:
                req.done = True
                req.t_done = self.now_us()
                finished.append(slot)
        for slot in finished:
            req = self.active.pop(slot)            # slot freed for reuse
            for page in req.pages:
                self.kv.release(page, th=self.th)
            self.kv.reclaim_chain(req.tail_pages, th=self.th)
            self.finished.append(req)
        self.steps += 1
        return len(self.active) + len(finished)

    def run(self, max_steps: int = 256) -> list[Request]:
        for _ in range(max_steps):
            if not self.queue and not self.active:
                break
            self.step()
        return self.finished

    # -- results -------------------------------------------------------------
    def digest(self) -> str:
        """Order-independent hash of every finished request's tokens: the
        DSM plane must reproduce the local plane's digest byte-for-byte
        at any cluster size."""
        items = sorted((r.rid, tuple(r.generated)) for r in self.finished)
        return hashlib.sha256(repr(items).encode()).hexdigest()

    def stats(self) -> dict:
        out = {"steps": self.steps, "kv": self.kv.stats(),
               "weight_refreshes": self.weight_cache.refreshes,
               "weight_hits": self.weight_cache.hits,
               "wire_bytes": self.wire_bytes,
               "completed": len(self.finished)}
        if self.cluster is not None:
            out["guard_stats"] = dict(
                getattr(self.cluster.backend, "guard_stats", {}) or {})
        return out


class ServeFleet:
    """One engine replica per server over a shared page table.

    The fleet is the read-mostly-sharing shape the protocol optimizes:
    shared prefix pages are fetched remotely once per replica and then
    serve from that replica's local cache; each replica appends only to
    its own requests' private chains.  Arrivals route round-robin;
    ``step()`` advances the replica with the earliest virtual clock, so
    the fleet's makespan is honest under open-loop load.
    """

    def __init__(self, cluster, n_replicas: int | None = None, **engine_kw):
        self.cluster = cluster
        n = n_replicas or cluster.sim.n
        shared_kv = None
        self.engines: list[ServeEngine] = []
        for r in range(n):
            eng = ServeEngine(cluster=cluster, server=r % cluster.sim.n,
                              kv=shared_kv, **engine_kw)
            if shared_kv is None:
                shared_kv = eng.kv                 # fleet-wide page table
            self.engines.append(eng)
        self.kv = shared_kv
        self._rr = 0
        self._rid = itertools.count()   # fleet-global: digests stay
        # comparable with a single engine fed the same submission order

    def submit(self, prompt, max_new: int = 16,
               t_arrive: float | None = None) -> Request:
        eng = self.engines[self._rr % len(self.engines)]
        self._rr += 1
        return eng.submit(prompt, max_new, t_arrive=t_arrive,
                          rid=next(self._rid))

    @property
    def queue(self):
        return [r for e in self.engines for r in e.queue]

    @property
    def active(self):
        return {(i, s): r for i, e in enumerate(self.engines)
                for s, r in e.active.items()}

    @property
    def finished(self):
        return [r for e in self.engines for r in e.finished]

    @property
    def weights(self):
        return self.engines[0].weights

    def now_us(self) -> float:
        return min(e.now_us() for e in self.engines)

    def advance_to(self, t_us: float) -> None:
        for e in self.engines:
            if not e.queue and not e.active:
                e.advance_to(t_us)

    def step(self) -> int:
        """Advance the replica with work and the earliest clock — the
        deterministic analogue of 'whichever replica is free next'."""
        ready = [e for e in self.engines if e.queue or e.active]
        if not ready:
            return 0
        eng = min(ready, key=lambda e: (e.now_us(), self.engines.index(e)))
        return eng.step()

    def digest(self) -> str:
        items = sorted((r.rid, tuple(r.generated)) for r in self.finished)
        return hashlib.sha256(repr(items).encode()).hexdigest()

    def stats(self) -> dict:
        return {"completed": len(self.finished),
                "kv": self.kv.stats(),
                "wire_bytes": sum(e.wire_bytes for e in self.engines),
                "weight_refreshes": sum(e.weight_cache.refreshes
                                        for e in self.engines),
                "weight_hits": sum(e.weight_cache.hits
                                   for e in self.engines),
                "steps": sum(e.steps for e in self.engines)}
