"""The benchmark entry point of the port (the counterpart of
``benchmarks/run.py``):

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--fast|--quick] \\
        [--device cuda|cpu] [--out PATH]

Every mode prints ``name,us_per_call,derived`` CSV and runs on the card
unless ``--device cpu``: GEMM's tiles, DataFrame's chunks and the serving
sweep's weights are tensors on that device, and the kernel bench times the
CUDA kernels there (the plain versions, rows ``kernel_<name>_plain``, on
the CPU).

The full run, as the reference's: the paper's figures and tables
(``paper_figs``), the protocol micro-benchmarks, the kernel bench and,
when ``artifacts/dryrun_torch/`` holds dry-run records, their roofline
rows.  ``--fast`` runs the figures at 1 and 8 nodes and the kernel bench
without K4 and K5.

``--quick`` runs the protocol micro-benchmarks and the batched-I/O-plane app
sweep, as the reference's ``--quick`` does.  It builds the same summary as
the reference's ``BENCH_protocol.json`` and writes it only to ``--out
PATH``: the committed file is the reference's baseline and is never
written over.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

from repro_torch.apps.gemm import run_gemm
from repro_torch.apps.kvstore import run_kvstore
from repro_torch.apps.socialnet import run_socialnet
from repro_torch.apps.dataframe import run_dataframe
from repro_torch.models.transformer import resolve_device

from . import protocol_micro

# the committed baseline, which no run of the port writes over
COMMITTED = (pathlib.Path(__file__).resolve().parents[3]
             / "BENCH_protocol.json")


def _app_stats(r) -> dict:
    return {
        "makespan_us": round(r.makespan_us, 2),
        "round_trips": r.net["round_trips"],
        "bytes_moved": r.net["bytes_moved"],
        "doorbell_batches": r.net["doorbell_batches"],
        "batched_verbs": r.net["batched_verbs"],
        "async_writebacks": r.net["async_writebacks"],
        "fences": r.net["fences"],
        "fenced_verbs": r.net["fenced_verbs"],
        "ooo_completions": r.net["ooo_completions"],
        "qp_switches": r.net["qp_switches"],
        "speculative_fetches": r.net["speculative_fetches"],
        "late_fences": r.net["late_fences"],
        "wasted_prefetches": r.net["wasted_prefetches"],
    }


# the "apps" section: each app's kwargs, and the three planes it runs on
# ("batched"/"unbatched" keep the manual choreography planes; "auto" is the
# runtime coalescer with zero app choreography)
APPS = {"socialnet": (run_socialnet, dict(n_requests=120)),
        "dataframe": (run_dataframe, dict(n_columns=4, chunks_per_column=8,
                                          n_ops=4, use_tbox=True))}
APP_MODES = (("batched", dict(batch_io=True, coalesce="manual")),
             ("unbatched", dict(batch_io=False, coalesce="manual")),
             ("auto", dict(batch_io=True, coalesce="auto")))


def apps_entry(app: str, device="cuda") -> dict:
    """One app's row of the ``apps`` section."""
    fn, kw = APPS[app]
    if fn is run_dataframe:                  # the app whose chunks are tensors
        kw = dict(kw, device=device)
    entry = {mode: _app_stats(fn(4, "drust", **mkw, **kw))
             for mode, mkw in APP_MODES}
    entry["rtt_ratio"] = round(
        entry["unbatched"]["round_trips"]
        / max(1, entry["batched"]["round_trips"]), 2)
    return entry


def prefetch_entry(name: str, device="cuda") -> dict:
    """One row of the ``prefetch`` section (the speculative-prefetch
    trajectory: the deferred-fence/wasted counters are deterministic)."""
    if name == "gemm_prefetch":
        r = run_gemm(4, "drust", n=256, tile=64, prefetch=True,
                     device=device)
    else:
        r = run_kvstore(4, "drust", n_keys=256, n_ops=600,
                        prefetch_window=8)
    return {
        "makespan_us": round(r.makespan_us, 2),
        "round_trips": r.net["round_trips"],
        "speculative_fetches": r.net["speculative_fetches"],
        "late_fences": r.net["late_fences"],
        "wasted_prefetches": r.net["wasted_prefetches"],
    }


PREFETCH = ("gemm_prefetch", "kvstore_window8")


def _sections(dev):
    """(section, thunk) for every section of the summary, in the order the
    reference's ``quick()`` runs them."""
    pm = protocol_micro
    return (
        ("micro", lambda: {name: {"us": round(us, 3), "derived": derived}
                           for name, us, derived in pm.all_rows(dev)}),
        ("qp_sweep", pm.qp_sweep_summary),
        ("coalesce_sweep", pm.coalesce_summary),
        ("recovery", pm.recovery_summary),
        ("recovery_slo", pm.recovery_slo),
        ("serve", lambda: pm.serve_summary(dev)),
        ("lock_sweep", pm.lock_sweep_summary),
        ("placement_sweep", lambda: pm.placement_summary(device=dev)),
        ("sanitize_overhead", pm.sanitize_overhead_summary),
        ("apps", lambda: {app: apps_entry(app, dev) for app in APPS}),
        ("prefetch", lambda: {name: prefetch_entry(name, dev)
                              for name in PREFETCH}),
    )


def quick(out_path=None, device="cuda", seconds: dict | None = None) -> dict:
    """The reference's ``quick()`` summary, every section of
    ``BENCH_protocol.json``, with the runs' tensors on ``device``
    (``cuda`` raises without a card).  Writes the JSON to ``out_path``
    only when one is given, never over the committed baseline.
    ``seconds``, when given, receives each section's wall seconds."""
    if out_path is not None and \
            pathlib.Path(out_path).resolve() == COMMITTED:
        raise ValueError(f"{COMMITTED} is the reference's baseline: write "
                         f"the port's summary elsewhere")
    dev = resolve_device(device)
    summary: dict = {}
    for name, fn in _sections(dev):
        t0 = time.perf_counter()
        summary[name] = fn()
        if seconds is not None:
            seconds[name] = time.perf_counter() - t0
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=2, sort_keys=True)
    return summary


# the fields that hold wall-clock times: no two runs share them
WALL_CLOCK_ROWS = ("clone_dict_fastpath_speedup",
                   "clone_list_fastpath_speedup")          # in "micro"
WALL_CLOCK_FIELDS = ("wall_ms_off", "wall_ms_on",
                     "overhead_x")                         # "sanitize_overhead"
_MISSING = object()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    else:
        yield path, tree


def is_wall_clock(section: str, path: tuple) -> bool:
    return ((section == "micro" and path[0] in WALL_CLOCK_ROWS)
            or (section == "sanitize_overhead"
                and path[-1] in WALL_CLOCK_FIELDS))


def diff_sections(summary: dict, baseline: dict) -> dict:
    """Each section of either summary -> (the number of fields compared,
    the paths whose values differ or that one side lacks).  Every field
    but the wall-clock ones is compared with ``==``."""
    out = {}
    for section in sorted(set(summary) | set(baseline)):
        mine = dict(_leaves(summary.get(section, {})))
        theirs = dict(_leaves(baseline.get(section, {})))
        keys = [k for k in sorted(set(mine) | set(theirs), key=str)
                if not is_wall_clock(section, k)]
        bad = ["/".join((section, *map(str, k))) for k in keys
               if mine.get(k, _MISSING) != theirs.get(k, _MISSING)]
        out[section] = (len(keys), bad)
    return out


def print_csv(summary: dict) -> None:
    """The reference's ``--quick`` CSV."""
    print("name,us_per_call,derived")
    for name, meta in summary["micro"].items():
        print(f"{name},{meta['us']:.2f},{meta['derived']}")
    for app, entry in summary["apps"].items():
        print(f"quick_{app}_rtt_ratio,0.00,{entry['rtt_ratio']}")
    for name, meta in summary["qp_sweep"].items():
        print(f"quick_qp_{name},{meta['makespan_us']:.2f},"
              f"{meta['ooo_completions']}")
    for name, meta in summary["coalesce_sweep"].items():
        print(f"quick_coalesce_{name},{meta['makespan_us']:.2f},"
              f"{meta['auto_over_best']}")
    for name, meta in summary["prefetch"].items():
        print(f"quick_prefetch_{name},{meta['makespan_us']:.2f},"
              f"{meta['speculative_fetches']}")
    for name, meta in summary["recovery"].items():
        print(f"quick_recovery_{name},{meta['makespan_us']:.2f},"
              f"{meta['restored_bytes']}")
    for name, meta in summary["lock_sweep"].items():
        print(f"quick_lock_{name},{meta['makespan_us']:.2f},"
              f"{meta['round_trips']}")
    for name, meta in summary["serve"].items():
        print(f"quick_serve_{name}_p99,{meta['p99_us']:.2f},"
              f"{meta['goodput_tok_s']}")
    for name, meta in summary["placement_sweep"].items():
        print(f"quick_placement_{name},{meta['makespan_us']:.2f},"
              f"{meta['round_trips']}")
    slo = summary["recovery_slo"]
    print(f"quick_recovery_slo_ok,0.00,{slo['slo_ok']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="write the summary JSON here (nothing is written "
                         "without it)")
    a = ap.parse_args(argv)
    if a.quick:
        print_csv(quick(a.out, a.device))
        if a.out is not None:
            print(f"wrote {a.out}", file=sys.stderr)
        return 0
    print("name,us_per_call,derived")
    for name, us, derived in full_rows(a.fast, a.device):
        print(f"{name},{us:.2f},{derived}")
    return 0


def full_rows(fast: bool = False, device="cuda"):
    """The rows of the full run (``--fast``: the short one), in the
    reference's order: figures, protocol micro-benchmarks, kernel bench,
    roofline; each section's rows as its module yields them."""
    from . import kernel_bench, paper_figs, roofline
    dev = resolve_device(device)
    yield from paper_figs.all_rows(fast=fast, device=dev)
    yield from protocol_micro.all_rows(dev)
    yield from kernel_bench.all_rows(fast=fast, device=dev)
    yield from roofline.all_rows()


if __name__ == "__main__":
    sys.exit(main())
