"""Run one cell of the benchmark of ``repro_torch`` on this machine's
card and print its result as the last line of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled window.  Every run also checks the
timed path against the plain float32 reference (``correct``).  Without a
card, or with fewer cards than the cell asks for, it exits with 3 and
prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def environment() -> None:
    """Before torch is imported: the allocator setting the port's MoE
    steps need, no JAX under a library, and every cache in the
    checkout."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def forbidden_modules(names=None) -> list:
    """The modules of ``names`` (the loaded ones by default) whose
    top-level name is JAX's or the JAX package's (the whole name before
    the first dot: ``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()

    from perfbench import spec, training
    cell = spec.load_cell(args.workload)

    import torch
    print(f"torch imported: {time.perf_counter() - T0:.4f} s",
          file=sys.stderr)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {n}: no result", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    result = training.run(cell, args.seed, args.seconds, bool(args.trace),
                          device, T0)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}; no result",
              file=sys.stderr)
        return 4
    for name, (value, limit) in result["compared"].items():
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
