"""What the readers of a model whose attention layers differ in kind
share: each layer's (query, key) pairs, K2's count of a call at a given
number of pairs, the bound a call averaged over the layer pattern, and the
device ms of the spans of one attention kind.

A windowed layer keeps key j for query i when i - window < j <= i; every
``global_every``-th layer (the configuration's ``model``) is full, causal
over every earlier key.  The counts take the form of ``counts.k2_fwd`` and
``counts.k2_bwd`` with the pairs of the call in place of the causal
pairs; bytes are the same for both kinds (q, k, v read once, the output
and the log-sum-exp written once)."""

from __future__ import annotations

from perfbench import counts
from perfbench.metrics._spans import _nodes, phase_ms, window_steps


def window_pairs(T: int, W: int) -> int:
    """(query, key) pairs of one head of attention over T positions with
    a window of W keys (the query's own among them)."""
    if T <= W:
        return counts.causal_pairs(T)
    return W * T - W * (W - 1) // 2


def layer_windows(model: dict) -> list:
    """Each layer's window, 0 for a full layer."""
    W, g = model.get("window", 0), model.get("global_every", 0)
    return [0 if g and i % g == g - 1 else W
            for i in range(model["n_layers"])]


def layer_pairs(model: dict, T: int) -> list:
    """Each layer's (query, key) pairs of one head and one row."""
    return [window_pairs(T, W) if W else counts.causal_pairs(T)
            for W in layer_windows(model)]


def k2_fwd(B, H, Hkv, T, hd, pairs, es=2):
    """``counts.k2_fwd`` over ``pairs`` pairs a head and row."""
    flops = 4 * B * pairs * H * hd
    nbytes = es * (2 * B * H * T * hd + 2 * B * Hkv * T * hd) \
        + counts.F32 * B * H * T
    return flops, nbytes


def k2_bwd(B, H, Hkv, T, hd, pairs, es=2):
    """``counts.k2_bwd`` over ``pairs`` pairs a head and row."""
    flops = 10 * B * pairs * H * hd
    nbytes = es * (4 * B * H * T * hd + 4 * B * Hkv * T * hd) \
        + counts.F32 * B * H * T
    return flops, nbytes


def mean_bound(model: dict, B: int, T: int, count) -> float:
    """The bound of one K2 call, in seconds, averaged over the layers:
    ``count`` (``k2_fwd`` or ``k2_bwd``) at each layer's pairs."""
    H, Hkv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    bounds = [counts.bound_s(*count(B, H, Hkv, T, hd, p))
              for p in layer_pairs(model, T)]
    return sum(bounds) / len(bounds)


def span_ms(window, kind: str):
    """Device ms a step of the spans ``repro_torch/attn_<kind>``, or None
    where the window's step trees hold none (a program without them)."""
    trees = window_steps(window)
    name = f"repro_torch/attn_{kind}"
    if trees is None or not any(n["name"] == name for t in trees
                                for n in _nodes(t)):
        return None
    return phase_ms(window, f"attn_{kind}")
