"""Shared harness for the evaluation applications."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import Cluster


@dataclass
class AppResult:
    app: str
    backend: str
    n_servers: int
    ops: int
    makespan_us: float
    net: dict = field(default_factory=dict)
    extra: dict = field(default_factory=dict)

    @property
    def throughput(self) -> float:
        return self.ops / (self.makespan_us / 1e6) if self.makespan_us else 0.0


def plain_time_us(total_cycles: float, total_local_accesses: int,
                  cores: int, ghz: float = 2.6,
                  local_access_us: float = 0.14) -> float:
    """The original single-machine program: perfect parallelism over
    ``cores``, no DSM checks, all accesses local."""
    return (total_cycles / (ghz * 1e3) + total_local_accesses * local_access_us) / cores


def zipf_keys(n_ops: int, n_keys: int, alpha: float = 0.99,
              seed: int = 0) -> np.ndarray:
    """YCSB-style zipfian key sequence (default skew 0.99)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    return rng.choice(n_keys, size=n_ops, p=p)


def make_cluster(n_servers: int, backend: str, cores: int = 16,
                 **kw) -> Cluster:
    return Cluster(n_servers, backend=backend, cores_per_server=cores, **kw)


PLACEMENT_MODES = ("static", "spread", "packed", "auto")


def placement_cluster_kw(placement: str) -> dict:
    """Cluster kwargs for an app ``placement=`` mode: only ``"auto"``
    installs the tracker; every static layout runs the byte-identical
    default plane."""
    if placement not in PLACEMENT_MODES:
        raise ValueError(f"unknown placement mode {placement!r}")
    return {"placement": "auto"} if placement == "auto" else {}


def hot_layout_server(placement: str, j: int, n_servers: int) -> int:
    """Static home for hot object ``j``: ``packed`` piles the hot set on
    server 0 (co-located with one accessor, worst for the rest);
    ``spread``/``static`` stripe it round-robin (balanced, but every
    phase-dominant reader still crosses the wire for most of the set).
    ``auto`` starts from the spread layout and lets migration move it."""
    return 0 if placement == "packed" else j % n_servers


def run_skewed_phases(cl, ths, hot, *, n_phases: int = 6,
                      accesses_per_phase: int = 96, alpha: float = 0.99,
                      write_stride: int = 2, minority_stride: int = 6,
                      seed: int = 0) -> tuple[int, int]:
    """Phase-rotating zipf-skewed read/write mix over the ``hot`` handles —
    the placement-sweep workload (both skewed apps drive it with their own
    hot-set shapes).

    Each phase ``p`` has a *dominant* reader server ``p % n`` whose pinned
    workers issue most reads (a minority lands one server over, so
    dominance — not mere presence — must trigger migration); writers are
    *movable* compute placed by ``backend.locate``, i.e. they follow the
    data like a ``spawn_to`` operator would.  Every write bumps the
    object's version, so under a static layout the dominant server's next
    read is a cold re-fetch; with ``placement="auto"`` the box (and its
    TBox closure) migrates to the dominant server once per phase and the
    read-after-write cycle goes fully local.  The rotation guarantees no
    single static layout wins every phase.

    Returns ``(digest, ops)`` — the digest folds every value read, in
    schedule order, and the schedule is placement-independent, so any two
    placement modes must produce identical digests.
    """
    n = cl.sim.n
    by_server: dict[int, list] = {}
    for t in ths:
        by_server.setdefault(t.server, []).append(t)
    rr = {s: 0 for s in by_server}

    def worker_on(s):
        pool = by_server.get(s)
        if not pool:
            pool = by_server[min(by_server)]
            s = pool[0].server
        th = pool[rr[s] % len(pool)]
        rr[s] += 1
        return th

    versions = [0] * len(hot)
    digest = 0
    ops = 0
    for p in range(n_phases):
        dom = p % n
        keys = zipf_keys(accesses_per_phase, len(hot), alpha,
                         seed=seed * 1009 + p)
        for a, j in enumerate(keys):
            j = int(j)
            box = hot[j]
            if a % write_stride == 0:
                wt = worker_on(cl.backend.locate(box))
                versions[j] += 1
                with box.write(wt) as slot:
                    slot.set((j, versions[j]))
                ops += 1
            reader = worker_on((dom + 1) % n if a % minority_stride == 0
                               else dom)
            with box.read(reader) as v:
                digest = (digest * 1000003 + v[0] * 31 + v[1]) & ((1 << 61) - 1)
            ops += 1
        cl.close_quanta()            # phase boundary: quantum epoch ticks
    return digest, ops


def spread_threads(cluster: Cluster, per_server: int):
    """One batch of worker threads, evenly spread (paper methodology for the
    baselines; DRust's controller could do this adaptively)."""
    ths = []
    for s in range(cluster.sim.n):
        for _ in range(per_server):
            th = cluster.main_thread(0)
            th.server = s
            ths.append(th)
    return ths
