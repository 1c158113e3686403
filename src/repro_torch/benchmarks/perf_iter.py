"""§Perf iteration driver (the counterpart of ``benchmarks/perf_iter.py``):
trace one cell with config overrides, print the three roofline terms and
the delta against the stored baseline artifact.

    PYTHONPATH=src python -m repro_torch.benchmarks.perf_iter \\
        --arch granite-34b --shape decode_32k --set decode_shard_s=true \\
        [--device cuda|cpu] [--save tag]

The cell is traced on fake tensors by ``launch.dryrun.lower_cell`` on the
production mesh (16x16) over a fake process group, created here and
destroyed before the end; ``--device`` picks the card's path (default)
or the plain one.  The baseline is
``artifacts/dryrun_torch/<arch>_<shape>_pod1.json``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def parse_val(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return v


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (repeatable)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--save", default=None,
                    help="store artifact as artifacts/perf_torch/"
                    "<arch>_<shape>_<tag>.json")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch.dryrun import init_fake_group, lower_cell
    from repro_torch.launch.mesh import make_production_mesh
    from .roofline import ARTIFACTS, analyze

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = parse_val(v)

    key = configs.ALIASES.get(args.arch,
                              args.arch.replace("-", "_").replace(".", "_"))
    init_fake_group(256)
    try:
        rec = lower_cell(key, args.shape, make_production_mesh(),
                         overrides=overrides or None,
                         microbatches=args.microbatches, device=args.device)
    finally:
        dist.destroy_process_group()
    a = analyze(rec)
    print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in a.items()}, indent=1))
    base_file = ARTIFACTS / f"{key}_{args.shape}_pod1.json"
    if base_file.exists():
        b = analyze(json.loads(base_file.read_text()))
        for term in ("compute_s", "memory_s", "collective_s", "mem_gb"):
            if b[term]:
                print(f"  {term:13s} {b[term]:10.4f} -> {a[term]:10.4f} "
                      f"({a[term]/b[term]:.3f}x)")
        print(f"  roofline      {b['roofline_frac']:.4f} -> "
              f"{a['roofline_frac']:.4f}")
    if args.save:
        out = Path("artifacts/perf_torch")
        out.mkdir(parents=True, exist_ok=True)
        rec["overrides"] = overrides
        (out / f"{key}_{args.shape}_{args.save}.json").write_text(
            json.dumps(rec, indent=1))
    return a


if __name__ == "__main__":
    main()
