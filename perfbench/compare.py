"""The numbers ``correct`` compares, between the program's readings and
the reference's, and the verdict against a cell's limits.

  loss_gap    the largest relative gap of a step's loss
  grad_gap    the worst leaf's gap between the two norms of the first
              step's clipped gradient, over the reference's norm of that
              leaf or of the median leaf, whichever is larger
  change_gap  the worst leaf's such gap of the parameters' change over
              the first steps, over the leaves whose reference gradient
              is at least a thousandth of the median leaf's (a leaf
              whose gradient is nought to rounding moves by round-off
              alone)
  rows_gap    the worst leaf's distance between the two sides' vectors
              of the first step's clipped gradient's mean square over
              each row (``weights.row_means_sq``: what Adafactor keeps),
              over the reference's norm of that leaf's vector or of the
              median leaf's: the norms above average the error of each
              element away, this keeps the energy that coarser products
              add to every row

A cell's limits file (``limits/<cell>.json``) names the numbers it
compares, each with its limit; a number it does not name is not
compared there (``PERF.md`` says why).  Its ``"leaves"`` may name the
leaves a number is taken over in that cell (``{"rows_gap": [...]}``;
every leaf by default).
"""

from __future__ import annotations

import math
import statistics

import torch


def leaf_gaps(prog: dict, ref: dict, leaves=None) -> dict:
    """{path: that leaf's gap of norms} over ``leaves`` (every leaf by
    default), each over the reference's norm of that leaf or of the
    median leaf."""
    if set(prog) != set(ref):
        raise ValueError(f"leaves differ: {sorted(set(prog) ^ set(ref))}")
    floor = statistics.median(ref.values())
    return {k: _finite(abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30))
            for k in (ref if leaves is None else leaves)}


def _finite(x: float) -> float:
    """x, or infinity where it is not a number (max() would skip it)."""
    return x if math.isfinite(x) else math.inf


def _rel(p: float, r: float) -> float:
    return abs(p - r) / abs(r) if math.isfinite(p) else math.inf


def rows_gaps(prog: dict, ref: dict, leaves=None) -> dict:
    """{path: rows_gap of that leaf} of the readings' ``rows``, over
    ``leaves`` (every leaf by default)."""
    if set(prog) != set(ref):
        raise ValueError(f"leaves differ: {sorted(set(prog) ^ set(ref))}")
    norms = {k: float(torch.linalg.vector_norm(r)) for k, r in ref.items()}
    floor = statistics.median(norms.values())
    return {k: _finite(float(torch.linalg.vector_norm(prog[k] - ref[k]))
                       / max(norms[k], floor, 1e-30))
            for k in (ref if leaves is None else leaves)}


def gaps(prog: dict, ref: dict, leaves: dict | None = None) -> dict:
    """{number: value} from the two sides' readings (``reference.train``'s
    keys; the program's need no ``grad_raw``); ``leaves`` as a limits
    file's ``"leaves"``."""
    if len(prog["loss"]) != len(ref["loss"]):
        raise ValueError("the two sides ran different numbers of steps")
    raw = ref["grad_raw"]
    floor = statistics.median(raw.values())
    moved = [k for k in raw if raw[k] >= 1e-3 * floor]
    return {"loss_gap": max(_rel(p, r) for p, r in zip(prog["loss"],
                                                       ref["loss"])),
            "grad_gap": max(leaf_gaps(prog["grad"], ref["grad"]).values()),
            "change_gap": max(leaf_gaps(prog["change"], ref["change"],
                                        moved).values()),
            "rows_gap": max(rows_gaps(prog["rows"], ref["rows"],
                                      (leaves or {}).get("rows_gap"))
                            .values())}


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number the limits name within its limit, {number: [value,
    limit]})."""
    shown = {k: [values[k], lim] for k, lim in limits.items()
             if k != "leaves"}
    ok = all(math.isfinite(v) and v <= lim for v, lim in shown.values())
    return ok, shown
