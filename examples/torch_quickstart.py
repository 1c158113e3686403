"""Quickstart: the ownership-guided DSM in 60 lines, through the PyTorch port.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Walks the paper's accumulator example (Listing 1/2) on a simulated 4-server
cluster, then shows the same protocol driving a state store of tensors on
``--device`` (default ``cuda``).
"""

import argparse

import torch

from repro_torch.core import Cluster, addr as A
from repro_torch.core.torchstate import OwnedState, StateCache
from repro_torch.models.transformer import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    # --- Listing 2: the accumulator, distributed without code rewriting ----
    cl = Cluster(4, backend="drust")
    main_th = cl.main_thread(0)

    val = cl.backend.alloc(main_th, 8, 5)          # Box::new(5)
    b = cl.backend.alloc(main_th, 8, 10)           # Box::new(10)

    # local add: a.val += *b — the guard scopes ARE the borrow lifetimes
    # (read guard = immutable borrow of b, write guard = mutable of val)
    with b.read(main_th) as delta:
        with val.write(main_th) as w:
            w.update(lambda v: v + delta)
    with val.read(main_th) as v:
        print(f"local add  -> a.val == {v}")

    # spawn on another server: only the *pointers* ship (16 bytes)
    worker = cl.scheduler.spawn_to(b, lambda th: None, parent=main_th)
    with b.read(worker) as delta:                  # local on its home
        with val.write(worker) as w:               # moves val to worker
            w.update(lambda v: v + delta)
    print(f"remote add -> a.val == {cl.backend.read(main_th, val)} "
          f"(object now lives on server {A.server_of(val.g)})")
    print(f"network: {cl.sim.net.one_sided_reads} one-sided reads, "
          f"{cl.sim.net.invalidations} invalidations "
          f"(coherence came from ownership, not messages)\n")

    # --- the same protocol as a state store of tensors ---------------------
    weights = OwnedState("weights", {"w": torch.zeros(4, device=dev)})
    replica = StateCache()
    replica.fetch(weights)                         # replica caches color 0
    replica.fetch(weights)                         # zero-communication hit
    weights.write({"w": torch.ones(4, device=dev)})  # one write epoch
    tree = replica.fetch(weights)                  # color changed: refetch
    print(f"weight cache on {dev}: {replica.hits} zero-comm hits, "
          f"{replica.refreshes} refreshes, 0 invalidation messages "
          f"(w sums to {float(tree['w'].sum()):.0f})")


if __name__ == "__main__":
    main()
