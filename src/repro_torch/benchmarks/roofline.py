"""Roofline analysis over the port's dry-run artifacts (the counterpart of
``benchmarks/roofline.py``), for the NVIDIA H100.

Hardware model, one H100 SXM a device:
    peak bf16 compute : 989 TFLOP/s (NVIDIA's H100 SXM data sheet, dense,
                        at 700 W)
    HBM bandwidth     : 3.35 TB/s (the same data sheet)
    network           : 50 GB/s a card: a 16x16 mesh spans 32 nodes of 8
                        cards, and a DGX H100 gives each card one 400 Gb/s
                        NDR port (DGX H100 data sheet); the collective
                        bytes are per-device *wire* bytes with ring factors
                        (``launch/dryrun.py``).  Inside a node NVLink gives
                        900 GB/s a card (``NVLINK_BW``, not charged).

Per (arch x shape x mesh) cell:
    compute term    = FLOPs_per_dev / 989e12          [s]
    memory term     = bytes_per_dev / 3.35e12         [s]
    collective term = wire_bytes_per_dev / 50e9       [s]
    bottleneck      = argmax of the three (memory: the floor, every resident
                      byte once and the temporaries twice)
    MODEL_FLOPS     = 6*N*D (train) | 2*N*D (prefill) | 2*N_act*B (decode)
    useful_frac     = MODEL_FLOPS_per_dev / FLOPs_per_dev
    roofline_frac   = (MODEL_FLOPS_per_dev / peak) / step time: the MFU the
                      step would have at its roofline time

"""

from __future__ import annotations

import json
from pathlib import Path

from repro_torch.kernels import cost

PEAK_FLOPS = cost.PEAK_FLOPS["bfloat16"]    # 989e12, the kernels' bound's
HBM_BW = cost.HBM_BYTES_S                   # 3.35e12 B/s, the same
NET_BW = 50e9                   # B/s a card: one 400 Gb/s NDR port (DGX H100)
NVLINK_BW = 900e9               # B/s a card inside a node (H100 SXM data sheet)

ARTIFACTS = (Path(__file__).resolve().parents[3] / "artifacts"
             / "dryrun_torch")


def model_flops(rec: dict) -> float:
    """Cluster-total useful FLOPs for this cell's step."""
    n_active = rec["active_params"]
    tokens = rec["batch"] * rec["seq"]
    if rec["mode"] == "train":
        return 6.0 * n_active * tokens
    if rec["mode"] == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * rec["batch"]          # decode: one token/seq


def analyze(rec: dict) -> dict:
    n_dev = 1
    for v in rec["mesh"].values():
        n_dev *= v
    flops = rec["cost"].get("flops", 0.0)
    bytes_acc = max(rec["cost"].get("bytes_accessed", 0.0), 0.0)
    coll = sum(rec["collectives"].values())
    mem = rec.get("memory", {})
    # the traced bytes are an *unfused* upper bound; the floor moves every
    # resident byte once (+ temp written & read)
    floor_bytes = (mem.get("argument_size_in_bytes", 0)
                   + mem.get("output_size_in_bytes", 0)
                   + 2 * mem.get("temp_size_in_bytes", 0))
    t_c = flops / PEAK_FLOPS
    t_m = bytes_acc / HBM_BW
    t_mf = floor_bytes / HBM_BW
    t_n = coll / NET_BW
    terms = {"compute": t_c, "memory": t_mf, "collective": t_n}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(rec) / n_dev
    step_time = max(terms.values())
    return {
        "cell": f"{rec['arch']}x{rec['shape']}",
        "mesh": "x".join(str(v) for v in rec["mesh"].values()),
        "compute_s": t_c, "memory_s": t_m, "memory_floor_s": t_mf,
        "collective_s": t_n,
        "bottleneck": bottleneck,
        "model_flops_dev": mf,
        "useful_frac": (mf / flops) if flops else 0.0,
        "roofline_frac": (mf / PEAK_FLOPS) / step_time if step_time else 0.0,
        "mem_gb": (mem.get("argument_size_in_bytes", 0)
                   + mem.get("temp_size_in_bytes", 0)) / 1e9,
    }


def load_all(pattern: str = "*_pod1.json", include_opt: bool = False):
    out = []
    for f in sorted(ARTIFACTS.glob(pattern)):
        if "smoke" in f.name:
            continue
        if ("_opt" in f.name) != include_opt:
            continue
        out.append(analyze(json.loads(f.read_text())))
    return out


def opt_comparison() -> str:
    """Baseline vs --optimized table (only cells with an _opt artifact)."""
    base = {a["cell"]: a for a in load_all("*_pod1.json")}
    rows = ["| cell | step s (base→opt) | collective s (base→opt) "
            "| roofline (base→opt) | gain |",
            "|---|---|---|---|---|"]
    for a in load_all("*_pod1_opt.json", include_opt=True):
        b = base.get(a["cell"])
        if b is None:
            continue
        sb = max(b["compute_s"], b["memory_floor_s"], b["collective_s"])
        so = max(a["compute_s"], a["memory_floor_s"], a["collective_s"])
        rows.append(
            f"| {a['cell']} | {sb:.4f} → {so:.4f} "
            f"| {b['collective_s']:.4f} → {a['collective_s']:.4f} "
            f"| {b['roofline_frac']:.4f} → {a['roofline_frac']:.4f} "
            f"| {sb/so:.2f}x |")
    return "\n".join(rows)


def all_rows():
    rows = []
    for mesh_pat in ("*_pod1.json", "*_pod2.json"):
        for a in load_all(mesh_pat):
            rows.append((
                f"roofline_{a['cell']}_{a['mesh']}",
                max(a["compute_s"], a["memory_floor_s"],
                    a["collective_s"]) * 1e6,
                round(a["roofline_frac"], 4)))
    for a in load_all("*_pod1_opt.json", include_opt=True):
        rows.append((
            f"roofline_opt_{a['cell']}_{a['mesh']}",
            max(a["compute_s"], a["memory_floor_s"],
                a["collective_s"]) * 1e6,
            round(a["roofline_frac"], 4)))
    return rows


def table(pattern: str = "*_pod1.json") -> str:
    rows = load_all(pattern)
    hdr = ("| cell | mesh | compute s | mem(traced) s | mem(floor) s "
           "| collective s | bottleneck | useful | roofline | GB/dev |")
    sep = "|---|---|---|---|---|---|---|---|---|---|"
    lines = [hdr, sep]
    for a in rows:
        lines.append(
            f"| {a['cell']} | {a['mesh']} | {a['compute_s']:.4f} "
            f"| {a['memory_s']:.3f} | {a['memory_floor_s']:.4f} "
            f"| {a['collective_s']:.4f} | {a['bottleneck']} "
            f"| {a['useful_frac']:.3f} | {a['roofline_frac']:.4f} "
            f"| {a['mem_gb']:.1f} |")
    return "\n".join(lines)


if __name__ == "__main__":
    import sys
    print(table(sys.argv[1] if len(sys.argv) > 1 else "*_pod1.json"))
