"""The paper's headline comparison (Fig. 5) through the PyTorch port:

    PYTHONPATH=src python examples/torch_dsm_apps.py [app ...] [--device cpu]
        [--servers 1 2 4 8]

Runs the chosen applications (default: all four) on 1..8 simulated servers
under all three DSM protocols and prints the Fig. 5-style table, each
entry the original single-node program's time over the DSM run's.  GEMM's
tiles and DataFrame's chunks are tensors on ``--device`` (default
``cuda``); the simulated times are the same on any device.
"""

import argparse

from repro_torch.apps import APPS
from repro_torch.apps.dataframe import plain_dataframe_us
from repro_torch.apps.gemm import plain_gemm_us
from repro_torch.apps.kvstore import plain_kvstore_us
from repro_torch.apps.socialnet import plain_socialnet_us

PLAIN = {"gemm": plain_gemm_us, "dataframe": plain_dataframe_us,
         "kvstore": plain_kvstore_us, "socialnet": plain_socialnet_us}
ON_DEVICE = ("gemm", "dataframe")          # the apps whose payloads are tensors


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("apps", nargs="*", metavar="app",
                    help=f"any of {', '.join(APPS)} (default: all four)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--servers", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args(argv)
    unknown = sorted(set(args.apps) - set(APPS))
    if unknown:
        ap.error(f"unknown app(s) {unknown}: choose from {list(APPS)}")
    for app in args.apps or list(APPS):
        kw = {"device": args.device} if app in ON_DEVICE else {}
        plain = PLAIN[app]()
        print(f"\n== {app} (normalized to the original single-node program)")
        print(f"   {'backend':8s} "
              + "".join(f"{n}n      " for n in args.servers))
        for backend in ("drust", "gam", "grappa"):
            row = []
            for n in args.servers:
                r = APPS[app](n, backend=backend, **kw)
                row.append(f"{plain / r.makespan_us:5.2f}x ")
            print(f"   {backend:8s} " + " ".join(row))


if __name__ == "__main__":
    main()
