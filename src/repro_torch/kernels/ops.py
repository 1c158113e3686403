"""Public kernel entry points, dispatched by device.

A CUDA tensor goes to the hand-written kernel (built at first use), a CPU
tensor to its plain version in ``ref``; any other device raises.  Inside
``cost.card_path()`` a fake tensor goes to the kernel's wrapper, which
records the call in ``cost`` and launches nothing.  There is
no fallback: a kernel that cannot take a CUDA input raises.  This is the
counterpart of ``repro.kernels.ops``, where non-TPU backends run the Pallas
kernels in interpret mode.
"""

from __future__ import annotations

from . import adafactor as _adafactor
from . import adamw as _adamw
from . import cost
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import moe_gmm as _gmm
from . import ref
from . import rglru_scan as _rglru
from . import rwkv_scan as _rwkv

KERNELS = {"decode_attention": _decode, "flash_attention": _flash,
           "moe_gmm": _gmm, "rwkv_scan": _rwkv, "rglru_scan": _rglru,
           "adafactor": _adafactor, "adamw": _adamw}


def _on(t) -> str:
    """"cuda" for the card's path (``cost.on_card``: a fake tensor of a
    trace of it too), "cpu" for the plain one."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {t.device}")
    return "cuda" if cost.on_card(t) else "cpu"


# the kernels with a backward kernel, counted apart as "<name>_bwd"
BACKWARDS = ("flash_attention", "moe_gmm", "rwkv_scan", "rglru_scan")


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q: (B,H,T,hd); k,v: (B,Hkv,S,hd) -> (B,H,T,hd); differentiable on
    both devices (K2's backward kernel on the card)."""
    if _on(q) == "cuda":
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    return ref.attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, lengths):
    """q: (B,H,hd); k,v: (B,Hkv,S,hd); lengths: (B,) int32 -> (B,H,hd)."""
    if _on(q) == "cuda":
        return _decode.decode_attention(q, k, v, lengths)
    return ref.decode_attention(q, k, v, lengths)


def moe_gmm(x, w, rows=None, starts=None):
    """x: (E,C,D); w: (E,D,F) -> (E,C,F) in x.dtype, summed in float32;
    rows (E,) int32 or None: rows c >= rows[e] are zeros.  Ragged, with
    starts (E,) int32 beside rows: x (M,D) packed, expert e's rows
    starts[e] .. + rows[e], y (M,F).  Differentiable on both devices (K3's
    backward kernel on the card)."""
    if _on(x) == "cuda":
        return _gmm.moe_gmm(x, w, rows, starts)
    return ref.moe_gmm(x, w, rows, starts)


def rwkv_scan(r, k, v, logw, u, S0=None):
    """r,k,v,logw: (B,H,T,M); u: (H,M); S0: (B,H,M,M) or None -> (o
    (B,H,T,M) f32, S (B,H,M,M) f32); differentiable on both devices (K4's
    backward kernel on the card)."""
    if _on(r) == "cuda":
        return _rwkv.rwkv_scan(r, k, v, logw, u, S0)
    return ref.rwkv_scan(r, k, v, logw, u, S0)


def rglru_scan(a, b):
    """a, b: (B,T,D) f32 -> h (B,T,D) f32, h_t = a_t h_{t-1} + b_t;
    differentiable on both devices (K5's backward kernel on the card)."""
    if _on(a) == "cuda":
        return _rglru.rglru_scan(a, b)
    return ref.rglru_scan(a, b)


def adafactor_stats(g):
    """Adafactor's first pass over gradient leaf ``g``: (sum of squares,
    row sums of g^2 (..., R, 1), column sums (..., 1, C); None, None
    under two dims), float32."""
    if _on(g) == "cuda":
        return _adafactor.stats(g)
    return ref.adafactor_stats(g)


def adafactor_update(p, g, vr, vc, stats, scale, decay, lr, eps: float,
                     wd: float) -> None:
    """Adafactor's update of leaf ``p`` and its state ``vr``/``vc`` in
    place, from ``adafactor_stats``' ``stats`` and the step's 0-d
    ``scale``, ``decay`` and ``lr``."""
    if _on(p) == "cuda":
        return _adafactor.update(p, g, vr, vc, stats, scale, decay, lr, eps,
                                 wd)
    return ref.adafactor_update(p, g, vr, vc, stats, scale, decay, lr, eps,
                                wd)


def adamw_sumsq(g):
    """AdamW's first pass over gradient leaf ``g``: its sum of squares,
    0-d float32."""
    if _on(g) == "cuda":
        return _adamw.sumsq(g)
    return ref.adamw_sumsq(g)


def adamw_update(p, g, mu, nu, scale, lr, bc1, bc2, *, b1: float, b2: float,
                 eps: float, wd: float) -> None:
    """AdamW's update of leaf ``p`` and its moments ``mu``/``nu`` in place,
    from the step's 0-d ``scale`` (the clip), ``lr`` and bias corrections
    ``bc1``/``bc2``."""
    if _on(p) == "cuda":
        return _adamw.update(p, g, mu, nu, scale, lr, bc1, bc2, b1=b1, b2=b2,
                             eps=eps, wd=wd)
    return ref.adamw_update(p, g, mu, nu, scale, lr, bc1, bc2, b1=b1, b2=b2,
                            eps=eps, wd=wd)


def launch_counts() -> dict[str, int]:
    """Wrapper calls per kernel since the last ``reset_launch_counts``;
    ``<name>_bwd`` counts the backward calls of each kernel in
    ``BACKWARDS`` apart from its forward (K2's backward is three CUDA
    launches, or four with its heads split; K3's two, K4's four, K5's
    one); ``adafactor`` counts leaves updated, three passes each, and
    ``adamw`` leaves updated, two passes each.
    ``bwd_routes`` of ``flash_attention``, ``moe_gmm`` and
    ``rwkv_scan`` split their backward calls by kernel, and
    ``moe_gmm.routes`` its forward launches."""
    counts = {name: mod.launches for name, mod in KERNELS.items()}
    for name in BACKWARDS:
        counts[f"{name}_bwd"] = KERNELS[name].bwd_launches
    return counts


def reset_launch_counts() -> None:
    for name, mod in KERNELS.items():
        mod.launches = 0
        if name in BACKWARDS:
            mod.bwd_launches = 0
    for mod in (_flash, _gmm, _rwkv):
        for route in mod.bwd_routes:
            mod.bwd_routes[route] = 0
    for route in _gmm.routes:
        _gmm.routes[route] = 0
