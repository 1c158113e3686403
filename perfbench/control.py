"""The readings that the limits of ``correct`` are set between, taken
on the card at a cell's own size, each compared with the float32
reference by the cell's numbers, seed by seed:

  program      the program's own set-up steps (the lower readings)
  fp8          the control: the reference put in the program's place one
               precision below the configuration's bf16, every product
               in fp8, the parameters stored in bf16 as the program
               stores them
  half_batch   the reference with half of each batch left out (a
               planted fault)
  bf16_params  the reference with its bf16 leaves stored in bf16 after
               each update (a look: what the configuration's own storage
               does to the numbers)

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13 \\
        --variants program bf16_params

prints one JSON line a seed and variant, with each leaf's gaps.  The
benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from run import environment

VARIANTS = {"fp8": {"prec": "fp8", "store": "bf16"},
            "half_batch": {},
            "bf16_params": {"store": "bf16"}}


def leaf_gaps(other: dict, base: dict) -> dict:
    """{number: {path: that leaf's gap}} of the per-leaf numbers."""
    from perfbench import compare
    return {"rows_gap": compare.rows_gaps(other["rows"], base["rows"]),
            "grad_gap": compare.leaf_gaps(other["grad"], base["grad"]),
            "change_gap": compare.leaf_gaps(other["change"],
                                            base["change"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["fp8", "half_batch"],
                    choices=("program",) + tuple(VARIANTS))
    args = ap.parse_args(argv)
    environment()
    import torch
    from perfbench import compare, spec, traffic, training
    from perfbench.reference import train as reference
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    tr = cell.traffic
    for seed in args.seeds:
        batches = traffic.device_batches(tr, cell.config["model"]["vocab"],
                                         tr["setup_steps"], seed, dev)
        readings = {}
        if "program" in args.variants:
            readings["program"] = training.program_readings(
                cell.config, seed, batches, dev)
        t = time.perf_counter()
        base = reference.train(cell.config, seed, batches, dev)
        t_base = time.perf_counter() - t
        for variant in args.variants:
            if variant == "program":
                continue
            kw = dict(VARIANTS[variant])
            if variant == "half_batch":
                kw["rows"] = slice(0, tr["batch"] // 2)
            readings[variant] = reference.train(cell.config, seed, batches,
                                                dev, **kw)
        for variant, other in readings.items():
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "variant": variant,
                              "gaps": compare.gaps(
                                  other, base, cell.limits.get("leaves")),
                              "first_loss_gap": abs(other["loss"][0]
                                                    - base["loss"][0])
                              / base["loss"][0],
                              "leaves": leaf_gaps(other, base),
                              "losses": [other["loss"], base["loss"]],
                              "reference_s": t_base}),
                  flush=True)
        del batches, base, readings
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
