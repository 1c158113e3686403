"""Benchmarks reproducing the paper's tables/figures (DRust, ATC'24), over
the port's apps and simulator (the counterpart of
``benchmarks/paper_figs.py``).

Each function returns rows of (name, us_per_call, derived) where ``derived``
is the figure's reported quantity (normalized throughput, overhead %, ...).
GEMM's tiles and DataFrame's chunks are tensors on ``device`` (``cuda``
unless the caller passes ``device="cpu"``); every other app carries byte
strings.  The rows are the reference's, value for value, but for the one
wall-clock column (``table2_deref_fastpath_wall``'s microseconds).
"""

from __future__ import annotations

import time

from repro_torch.apps import APPS
from repro_torch.apps.dataframe import plain_dataframe_us, run_dataframe
from repro_torch.apps.gemm import plain_gemm_us
from repro_torch.apps.kvstore import plain_kvstore_us
from repro_torch.apps.socialnet import plain_socialnet_us, run_socialnet
from repro_torch.core import CostModel, Cluster
from repro_torch.models.transformer import resolve_device

PLAIN = {
    "gemm": plain_gemm_us,
    "dataframe": plain_dataframe_us,
    "kvstore": plain_kvstore_us,
    "socialnet": plain_socialnet_us,
}
BACKENDS = ("drust", "gam", "grappa")
NODES = (1, 2, 4, 8)
ON_DEVICE = ("gemm", "dataframe")    # the apps whose payloads are tensors

# Paper Fig. 5 values at 8 nodes (normalized throughput), for the comparison
# column in EXPERIMENTS.md.
PAPER_8N = {
    ("gemm", "drust"): 5.93, ("gemm", "gam"): 3.82, ("gemm", "grappa"): 2.02,
    ("dataframe", "drust"): 5.57, ("dataframe", "gam"): 2.18,
    ("dataframe", "grappa"): 1.69,
    ("kvstore", "drust"): 3.34, ("kvstore", "gam"): 2.50,
    ("socialnet", "drust"): 3.51, ("socialnet", "gam"): 1.33,
    ("socialnet", "grappa"): 1.39,
}


def _run(app: str, *args, device="cuda", **kw):
    """``APPS[app](*args, **kw)``, on ``device`` for the apps that take one."""
    if app in ON_DEVICE:
        kw["device"] = device
    return APPS[app](*args, **kw)


def fig5_scaling(nodes=NODES, backends=BACKENDS, device="cuda"):
    """Fig. 5: strong scaling of 4 apps × 3 DSM systems, normalized to the
    original single-node program."""
    dev = resolve_device(device)
    rows = []
    for app in APPS:
        plain = PLAIN[app]()
        for backend in backends:
            for n in nodes:
                r = _run(app, n, backend=backend, device=dev)
                rows.append((f"fig5_{app}_{backend}_{n}n", r.makespan_us,
                             round(plain / r.makespan_us, 3)))
    for n in nodes:                      # Fig. 5b extra baseline
        r = run_socialnet(n, backend="drust", by_value=True)
        rows.append((f"fig5_socialnet_original_{n}n", r.makespan_us,
                     round(PLAIN["socialnet"]() / r.makespan_us, 3)))
    return rows


def fig6_affinity(device="cuda"):
    """Fig. 6: TBox / spawn_to ablation on DataFrame, 8 nodes.  Pinned to
    the manual plane so the figure isolates the affinity annotations (the
    runtime coalescer has its own sweep)."""
    dev = resolve_device(device)
    base = run_dataframe(8, "drust", coalesce="manual",
                         device=dev).makespan_us
    tb = run_dataframe(8, "drust", use_tbox=True, coalesce="manual",
                       device=dev).makespan_us
    both = run_dataframe(8, "drust", use_tbox=True, use_spawn_to=True,
                         coalesce="manual", device=dev).makespan_us
    return [
        ("fig6_dataframe_base", base, 1.0),
        ("fig6_dataframe_tbox", tb, round(base / tb, 3)),
        ("fig6_dataframe_tbox_spawnto", both, round(base / both, 3)),
    ]


def fig7_coherence_cost(device="cuda"):
    """Fig. 7: fixed total resources (16 cores) — 1 node vs 8 nodes.
    ``derived`` is the slowdown (%) of the 8-node split; the paper reports
    4-32% for DRust and 10-98% for the baselines."""
    dev = resolve_device(device)
    rows = []
    for app in APPS:
        if app == "socialnet":           # omitted in the paper's Fig. 7 too
            continue
        for backend in BACKENDS:
            one = _run(app, 1, backend=backend, workers_per_server=16,
                       cores=16, device=dev)
            eight = _run(app, 8, backend=backend, workers_per_server=2,
                         cores=2, device=dev)
            slow = (eight.makespan_us - one.makespan_us) / eight.makespan_us
            rows.append((f"fig7_{app}_{backend}", eight.makespan_us,
                         round(100 * slow, 1)))
    return rows


def table2_deref_latency():
    """Table 2: pointer-deref cost — DRust's check adds ~31 cycles."""
    cost = CostModel()
    plain_cycles = cost.local_access_us * cost.ghz * 1e3
    drust_cycles = (cost.local_access_us + cost.deref_check_us) * cost.ghz * 1e3
    # Wall-clock of the actual protocol fast path (hashmap hit), for context.
    cl = Cluster(2, backend="drust")
    th0 = cl.main_thread(0)
    th1 = cl.main_thread(0); th1.server = 1
    box = cl.backend.alloc(th0, 64, b"x" * 64)
    cl.backend.read(th1, box)                 # warm the cache
    t0 = time.perf_counter()
    n = 2000
    for _ in range(n):
        cl.backend.read(th1, box)
    wall_us = (time.perf_counter() - t0) / n * 1e6
    return [
        ("table2_deref_rust_cycles", 0.0, round(plain_cycles)),
        ("table2_deref_drust_cycles", 0.0, round(drust_cycles)),
        ("table2_deref_fastpath_wall", wall_us, round(drust_cycles)),
    ]


def sec3_breakdown():
    """§3: GAM uncached 512 B read — total vs pure-network time."""
    from repro_torch.core.baselines import GamBackend
    cost = CostModel()
    total = GamBackend.COLD_READ_BASE_US + cost.xfer_us(512)
    network = cost.one_sided_base_us + cost.xfer_us(512)
    coherence_pct = 100 * (total - network) / total
    return [
        ("sec3_gam_read_512B_total", total, round(coherence_pct, 1)),
        ("sec3_net_read_512B", network, 0.0),
    ]


def batch_plane_sweep(n_servers: int = 8, device="cuda"):
    """Batched I/O plane ablation (the reference's addition, not a paper
    figure): socialnet/dataframe with the doorbell-coalesced plane on vs
    the *naive* per-object-verb plane (``batch_io=False``).  ``derived``
    is the naive/batched round-trip ratio; makespan rows carry the virtual
    wall clock."""
    dev = resolve_device(device)
    rows = []
    for app, kw in (("socialnet", {}), ("dataframe", {"use_tbox": True})):
        on = _run(app, n_servers, "drust", batch_io=True, coalesce="manual",
                  device=dev, **kw)
        off = _run(app, n_servers, "drust", batch_io=False,
                   coalesce="manual", device=dev, **kw)
        ratio = off.net["round_trips"] / max(1, on.net["round_trips"])
        rows.append((f"batchio_{app}_rtt_batched", on.makespan_us,
                     on.net["round_trips"]))
        rows.append((f"batchio_{app}_rtt_unbatched", off.makespan_us,
                     off.net["round_trips"]))
        rows.append((f"batchio_{app}_rtt_ratio", 0.0, round(ratio, 2)))
        rows.append((f"batchio_{app}_bytes_batched", 0.0,
                     on.net["bytes_moved"]))
        rows.append((f"batchio_{app}_bytes_unbatched", 0.0,
                     off.net["bytes_moved"]))
    return rows


def qp_depth_sweep(qp_counts=(1, 2, 4, 8), depths=(16, 64, 224),
                   n_servers: int = 8):
    """QP-count × write-back-depth sweep on the out-of-order completion
    plane (the reference's addition): ``derived`` is the makespan speedup
    over the single-QP plane at the same depth."""
    from .protocol_micro import _qp_wb_run
    rows = []
    for d in depths:
        base = None
        for q in qp_counts:
            cl, _ = _qp_wb_run(q, d, n_servers)
            span = cl.makespan_us()
            if base is None:
                base = span
            rows.append((f"qpsweep_depth{d}_qps{q}", span,
                         round(base / span, 3)))
    return rows


def link_congestion_fairness(n_servers: int = 4, device="cuda"):
    """All three backends under the same shared-link congestion model:
    ``derived`` is the narrow-link (4 Gbps) / wide-link (40 Gbps) makespan
    ratio on the dataframe trace, with the completion model (``ooo=True``,
    2 QPs) held fixed on *both* legs so only the link width varies."""
    dev = resolve_device(device)
    rows = []
    narrow = CostModel(link_bw_bytes_per_us=500.0)
    kw = dict(n_columns=4, chunks_per_column=8, n_ops=4,
              ooo=True, qps_per_thread=2, device=dev)
    for backend in BACKENDS:
        plain = run_dataframe(n_servers, backend, **kw).makespan_us
        congested = run_dataframe(n_servers, backend, cost=narrow,
                                  **kw).makespan_us
        rows.append((f"linkcong_dataframe_{backend}", congested,
                     round(congested / plain, 3)))
    return rows


def sec73_migration():
    """§7.3: thread-migration latency (paper: ~218 us average)."""
    cl = Cluster(8, backend="drust")
    th = cl.main_thread(0)
    th.stack_bytes = 1 << 20
    lat = cl.scheduler.migrate(th, 3)
    return [("sec73_thread_migration", lat, round(lat, 1))]


def all_rows(fast: bool = False, device="cuda"):
    dev = resolve_device(device)
    rows = []
    rows += fig5_scaling(nodes=(1, 8) if fast else NODES, device=dev)
    rows += fig6_affinity(dev)
    rows += fig7_coherence_cost(dev)
    rows += batch_plane_sweep(device=dev)
    rows += qp_depth_sweep(depths=(16, 64) if fast else (16, 64, 224))
    rows += link_congestion_fairness(device=dev)
    rows += table2_deref_latency()
    rows += sec3_breakdown()
    rows += sec73_migration()
    return rows
