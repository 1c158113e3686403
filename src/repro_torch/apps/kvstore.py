"""KV Store (§7.1): chained-hash in-memory cache under YCSB zipf load.

The paper's most DSM-unfriendly app: poor locality, low compute intensity
(~48 cycles/byte), and mutex-synchronized buckets whose shared-state
semantics defeat ownership-based ordering — DRust degenerates gracefully
(one-sided RDMA atomics for the mutex + single object fetch), GAM pays
two-sided synchronization, Grappa serializes every hot key on its home
core (the skew collapse in Fig. 5d, and the dip every system takes when
going from one to two nodes).

Each bucket's mutex is homed on the bucket's server (co-located with its
value nodes) and guards only the chain walk (as in Memcached); value
processing happens outside the lock.  Workload: 90% GET / 10% SET over
zipf(0.99) keys (YCSB defaults).  ``lock_mode="delegate"`` ships the
chain walks to the bucket homes as combining-lock convoys instead of
spinning (see ``core/sync.py`` and ``docs/sync.md``).

``txn_frac=f`` turns that fraction of ops into **multi-key transactions**:
each atomically updates 2–4 keys under sorted bucket-lock acquisition
(deadlock-free by global lock order), walking each chain and writing each
value *while holding the locks*.  SET/transaction payloads are
deterministic functions of (key, op index), so the final store contents
digest (``extra["digest"]``) is byte-identical across backends and
completion planes — the transactional correctness oracle.

``prefetch_window=W`` (drust only) speculatively fetches the value nodes
of the next W queued keys before taking the bucket lock — the fetch
overlaps the chain walk, and the value deref pays only a deferred
completion fence (``late_fences``).  Unlike GEMM's immutable tiles, SETs
race the lookahead: a write landing on a prefetched-but-unused node
invalidates its speculative copy (``wasted_prefetches``) — the
ownership-transfer visibility rule is what keeps the speculation safe.
"""

from __future__ import annotations

import hashlib

import numpy as np

from repro_torch.core import DMutex, addr as A
from .common import AppResult, make_cluster, spread_threads, zipf_keys

CYCLES_PER_BYTE = 48.15
SIMD_LANES = 8                   # value memcmp/copy vectorizes


def _val(key: int, i: int, value_bytes: int) -> bytes:
    """Deterministic SET payload: a (key, op-index) tag padded to size —
    what makes the cross-backend digest a meaningful oracle."""
    tag = b"k%d:i%d" % (key, i)
    return tag.ljust(value_bytes, b"\0")[:value_bytes]


def _peek(cl, h) -> bytes:
    """Oracle-only heap peek (no verbs): the node's current payload."""
    raw = A.clear_color(h.g) if hasattr(h, "g") else h.raw
    return bytes(cl.heap.get(raw).data)


def run_kvstore(n_servers: int, backend: str = "drust",
                n_keys: int = 4096, value_bytes: int = 1024,
                n_ops: int = 3000, get_frac: float = 0.9,
                workers_per_server: int = 4, cores: int = 16,
                nodes_per_bucket: int = 2, prefetch_window: int = 0,
                lock_mode: str = "spin", txn_frac: float = 0.0,
                seed: int = 0, **cluster_kw) -> AppResult:
    cl = make_cluster(n_servers, backend, cores, **cluster_kw)
    rng = np.random.default_rng(seed)
    boot = cl.main_thread(0)

    # Ceiling division: every key's bucket (key // nodes_per_bucket) must
    # exist even when nodes_per_bucket does not divide n_keys — floor
    # division under-allocated and the tail keys raised IndexError.
    n_buckets = max(1, -(-n_keys // nodes_per_bucket))
    buckets = []                     # bucket -> (mutex, [value handles])
    for b in range(n_buckets):
        mtx = DMutex(cl, boot, value=b, size=64, mode=lock_mode,
                     server=b % n_servers)
        nodes = [cl.backend.alloc(boot, value_bytes, bytes(value_bytes),
                                  server=b % n_servers)
                 for _ in range(nodes_per_bucket)]
        buckets.append((mtx, nodes))

    boot.t_us = 0.0
    for s in cl.sim.servers:
        s.cpu_busy_us = 0.0

    ths = spread_threads(cl, workers_per_server)
    keys = zipf_keys(n_ops, n_keys, seed=seed)
    is_get = rng.random(n_ops) < get_frac
    # Transactional mix: drawn after is_get so txn_frac=0 replays the
    # exact legacy op stream.
    is_txn = rng.random(n_ops) < txn_frac
    txn_extra = rng.integers(0, n_keys, size=(n_ops, 3))
    txn_nkeys = rng.integers(2, 5, size=n_ops)
    value_cycles = CYCLES_PER_BYTE * value_bytes / SIMD_LANES
    txn_ops = 0

    for i in range(n_ops):
        th = ths[i % len(ths)]
        key = int(keys[i])
        b, j = divmod(key, nodes_per_bucket)
        mtx, nodes = buckets[b]

        if is_txn[i]:
            # Multi-key atomic update: 2-4 distinct keys, locks taken in
            # global bucket order (deadlock-free), chains walked and
            # values written while ALL locks are held, released in
            # reverse order.  This is the workload that convoys on a
            # single-home lock design — and what delegation/distributed
            # homes unlock.
            txn_ops += 1
            tkeys = {key}
            for x in txn_extra[i][:int(txn_nkeys[i]) - 1]:
                tkeys.add(int(x))
            targets: dict[int, list[int]] = {}
            for k in sorted(tkeys):
                tb, tj = divmod(k, nodes_per_bucket)
                targets.setdefault(tb, []).append(tj)
            order = sorted(targets)
            held = []
            try:
                for tb in order:
                    buckets[tb][0].lock(th)
                    held.append(buckets[tb][0])
                for tb in order:
                    tmtx, tnodes = buckets[tb]
                    for tj in targets[tb]:
                        tmtx.charge_section(th, reads=tj + 1)  # chain walk
                        with tnodes[tj].write(th) as w:
                            w.set(_val(tb * nodes_per_bucket + tj, i,
                                       value_bytes))
            finally:
                for m in reversed(held):
                    m.unlock(th)
            continue

        ahead = []
        if prefetch_window:
            # Lookahead: this worker's next queued keys — fetches overlap
            # the lock walk; a SET racing the window wastes its prefetch.
            for i2 in range(i + len(ths), i + len(ths) * (prefetch_window + 1),
                            len(ths)):
                if i2 >= n_ops:
                    break
                b2, j2 = divmod(int(keys[i2]), nodes_per_bucket)
                ahead.append(buckets[b2][1][j2])

        # One region per request: the lookahead is an entry hint, the lock
        # walk + value access are the scope.
        with cl.region(th, prefetch=ahead):
            if lock_mode == "delegate":
                # The walk ships to the bucket home with the lock closure:
                # hash + j pointer hops run as local accesses there.
                mtx.with_lock(th, lambda _o: None, reads=j + 1)
            else:
                # Spin: lock remotely, walk the chain at the caller (the
                # per-hop summaries ride back in the acquire's cache line).
                def chain_walk(_obj, th=th, j=j):
                    for _ in range(j + 1):
                        cl.sim.local_access(th)
                    return None
                mtx.with_lock(th, chain_walk)

            # Value access outside the lock (SWMR per key).
            with nodes[j].read(th):
                cl.sim.compute(th, value_cycles)
            if not is_get[i]:
                with nodes[j].write(th) as w:
                    w.set(_val(key, i, value_bytes))

    makespan = cl.makespan_us()
    # Content digest over the final store, in key order — the cross-
    # backend / cross-plane transactional oracle (oracle-only peek, after
    # the makespan so it cannot perturb the run).
    dig = hashlib.sha256()
    for b, (_m, nodes) in enumerate(buckets):
        for j, h in enumerate(nodes):
            dig.update(b"%d:%d:" % (b, j))
            dig.update(_peek(cl, h))
    return AppResult("kvstore", backend, n_servers, n_ops, makespan,
                     net=cl.sim.snapshot()["net"],
                     extra={"prefetch_window": prefetch_window,
                            "lock_mode": lock_mode, "txn_ops": txn_ops,
                            "digest": dig.hexdigest()})


def plain_kvstore_us(n_ops: int = 3000, value_bytes: int = 1024,
                     workers_per_server: int = 4,
                     nodes_per_bucket: int = 2) -> float:
    per_op = (CYCLES_PER_BYTE * value_bytes / SIMD_LANES / 2.6e3
              + (nodes_per_bucket / 2 + 3) * 0.14)       # chase + lock + read
    return n_ops * per_op / workers_per_server
