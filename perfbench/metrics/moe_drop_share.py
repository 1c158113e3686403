"""The share of the routed (token, expert) pairs that the MoE's capacity
dropped in the traced window: 100 x (1 - kept / routed), from the
program's counters ``moe/kept_pairs`` and ``moe/routed_pairs`` in its step
trees.  ``k3_*_roofline`` counts every routed pair, so this is also how
far they over-read K3's work."""

from perfbench.metrics._spans import window_steps


def read(window):
    trees = window_steps(window)
    if trees is None:
        return None
    counts = [t.get("counts", {}) for t in trees]
    routed = sum(c.get("moe/routed_pairs", 0) for c in counts)
    if not routed:
        return None
    return 100.0 * (1.0 - sum(c.get("moe/kept_pairs", 0)
                              for c in counts) / routed)
