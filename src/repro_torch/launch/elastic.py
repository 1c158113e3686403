"""Elastic scaling: the live protocol-runtime rescale (the counterpart of
``repro.launch.elastic``).

    PYTHONPATH=src python -m repro_torch.launch.elastic --protocol \\
        [--servers 4]

The global address space stays fixed while the membership changes: a
server *crashes* under a live drust runtime (shrink), the controller's
probe loop declares it and the ``RecoveryManager`` fails it over (quiesce /
re-home / restripe — flushed data stays readable at its original
addresses), then the cluster *grows* with ``add_server`` and keeps
allocating on the new member.  Everything runs on the simulator's virtual
clocks.

The reference's other path, the checkpoint reshard from one device mesh to
another (its default without ``--protocol``), needs multi-device support,
which the port does not have yet (``ROADMAP.md`` Queue 1, item 10): it
raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.core import Cluster, ServerLostError


def rescale(n_servers: int = 4):
    """Crash server ``n-1``, probe-detect and fail it over, check that
    flushed data survives at its original addresses and the unflushed
    write is lost, then grow by one server and allocate on it.  Returns
    ``(ok, cluster, report)``, the ``RecoveryReport`` of the fail-over."""
    cl = Cluster(n_servers, "drust", replicate=True, qps_per_thread=2,
                 ooo=True, coalesce="auto")
    ths = [cl.main_thread(s) for s in range(n_servers)]
    victim = n_servers - 1

    # Populate every server, mutate, and flush the epoch (train-step edge).
    boxes = []
    for s, th in enumerate(ths):
        for i in range(8):
            b = cl.backend.alloc(th, 256, i + 100 * s, server=s)
            cl.backend.write(th, b, i + 1000 * s)
            boxes.append((s, i, b))
    cl.replicator.flush_epoch()
    dirty = cl.backend.alloc(ths[victim], 256, "dirty", server=victim)
    cl.backend.write(ths[victim], dirty, "unflushed")    # will be lost

    # Shrink: crash + probe loop until declared, recovery runs.
    cl.recovery.crash(victim)
    probe_th = ths[0]
    declared: list = []
    while not declared:
        declared = cl.controller.probe_failures(probe_th)
    report = cl.recovery.reports[-1]
    ok = declared == [victim] and report.server == victim
    ok &= report.rehomed_boxes >= 8 and report.lost_writes >= 1

    # Flushed data is readable at its original addresses, served by the
    # promoted backup; the unflushed write reverted to its flushed epoch.
    for s, i, b in boxes:
        ok &= cl.backend.read(ths[0], b) == i + 1000 * s
    try:
        cl.backend.read(ths[0], dirty)
        got_lost = True          # restored from replica map?  It never flushed
    except ServerLostError:
        got_lost = False
    ok &= not got_lost

    # Grow: a fresh server joins and takes allocations + traffic.
    s_new = cl.add_server()
    th_new = cl.main_thread(s_new)
    nb = cl.backend.alloc(th_new, 256, "fresh", server=s_new)
    ok &= cl.backend.read(ths[0], nb) == "fresh"
    ok &= s_new == n_servers and len(cl.sim.alive_servers()) == n_servers
    return bool(ok), cl, report


def report_line(n_servers: int, ok: bool, report) -> str:
    """The reference's one-line report of a rescale."""
    return (f"elastic protocol rescale {n_servers}->"
            f"{n_servers - 1}->{n_servers}: {'OK' if ok else 'MISMATCH'} "
            f"(rehomed {report.rehomed_boxes}, orphans "
            f"{report.orphaned_cids}, makespan "
            f"{report.makespan_us:.1f}us)")


def run_protocol(n_servers: int = 4, verbose: bool = True) -> bool:
    """Live rescale of a running protocol cluster (``rescale``); prints
    the reference's report line when ``verbose``."""
    ok, _, report = rescale(n_servers)
    if verbose:
        print(report_line(n_servers, ok, report))
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--protocol", action="store_true",
                    help="live protocol-runtime rescale (crash + fail-over "
                         "+ grow); the checkpoint reshard is not ported")
    ap.add_argument("--servers", type=int, default=4)
    a = ap.parse_args(argv)
    if not a.protocol:
        raise NotImplementedError(
            "checkpoint reshard across device meshes: multi-device support "
            "is ROADMAP Queue 1 item 10")
    return 0 if run_protocol(a.servers) else 1


if __name__ == "__main__":
    sys.exit(main())
