"""What the readers of K3 over its kept pairs share: the (token, expert)
pairs the MoE's experts kept under their capacity a ``moe_block`` call,
averaged over the traced window's calls (forward and remat's recompute):
the program's counter ``moe/kept_pairs`` over the ``repro_torch/moe``
spans of its step trees.  K3 multiplies only the kept rows of each
expert, so this is its work; ``k3_*_roofline`` count every routed pair.

A call's bound is taken at the mean of the calls' pairs; the bound is
convex in the pairs (the larger of two lines), so this reads no higher
than the bound of each call summed."""

from perfbench.metrics._roofline import bound
from perfbench.metrics._spans import _nodes, window_steps


def pairs_a_call(window):
    """Kept pairs a ``moe_block`` call, or None where the step trees hold
    no MoE span or no kept pair."""
    trees = window_steps(window)
    if trees is None:
        return None
    kept = sum(t.get("counts", {}).get("moe/kept_pairs", 0) for t in trees)
    calls = sum(n["name"] == "repro_torch/moe" for t in trees
                for n in _nodes(t))
    if not calls or not kept:
        return None
    return float(kept) / calls


def mean_bound(window, count):
    """The bound of one K3 call over the kept pairs, averaged over a
    layer's three products (gate and up d -> f, down f -> d); ``count``
    is ``counts.k3_fwd`` or ``counts.k3_bwd``.  None as
    ``pairs_a_call``."""
    m = window.model
    pairs = pairs_a_call(window)
    if not m.get("n_experts") or pairs is None:
        return None
    E, d, f = m["n_experts"], m["d_model"], m["moe_d_ff"]
    return (2 * bound(count(pairs, E, d, f)) + bound(count(pairs, E, f, d))) \
        / 3
