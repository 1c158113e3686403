"""Wire / checkpoint compression: symmetric int8 quantization on tensors
(the counterpart of ``repro.dist.compression``).

``quantize_int8`` maps a float tensor to (int8 codes, f32 scale) with
absolute error bounded by ``scale / 2``.  ``torch.round`` rounds half to
even like ``jnp.round``, and the scale is computed with the same float32
operations, so codes, scales and ``wire_bytes`` equal the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.core.torchstate import tree_leaves, tree_map

_TINY = 1e-30


def _is_packed(x) -> bool:
    """A leaf produced by ``quantize_tree``."""
    return isinstance(x, dict) and set(x) == {"q", "scale", "dtype"}


def quantize_int8(x, axis=None):
    """Quantize to int8 with a symmetric scale.

    ``axis=None`` uses one scale per tensor; an int/tuple keeps a scale
    per remaining dim (channel-wise).  Returns ``(codes int8, scale f32)``
    with ``|x - codes*scale| <= scale/2``.
    """
    xf = torch.as_tensor(x).to(torch.float32)
    amax = xf.abs().amax() if axis is None \
        else xf.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(_TINY) / 127.0
    codes = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return codes, scale


def dequantize_int8(codes, scale):
    return codes.to(torch.float32) * scale


def error_bound(scale) -> float:
    """The most ``|x - dequantize_int8(*quantize_int8(x))|`` can be for a
    per-tensor ``scale``: half a step, plus the float32 rounding of the
    division x / scale and of the product codes * scale (each within 2^-24
    of up to 127 steps; 2^-14 of a step covers both).  Without the rounding
    term a value on a half step, common in bf16 data, can exceed scale / 2
    by one float32 ulp."""
    return float(scale) * (0.5 + 2 ** -14)


def quantize_tree(tree, min_size: int = 64):
    """Quantize every float leaf with ``numel >= min_size``; small leaves
    (norms, scalars) stay exact.  A stacked leaf (leading layer dim) gets
    one scale, as in the reference.  Numpy leaves are taken as tensors."""
    def one(leaf):
        if leaf is None:
            return None
        arr = torch.as_tensor(leaf)
        if arr.numel() < min_size or not arr.is_floating_point():
            return arr
        q, s = quantize_int8(arr)
        return {"q": q, "scale": s, "dtype": arr.dtype}
    return tree_map(one, tree)


def dequantize_tree(tree):
    def one(leaf):
        if _is_packed(leaf):
            return dequantize_int8(leaf["q"], leaf["scale"]).to(leaf["dtype"])
        return leaf
    return tree_map(one, tree, is_leaf=_is_packed)


def wire_bytes(tree) -> int:
    """Bytes a (possibly quantized) tree occupies on the wire."""
    total = 0
    for leaf in tree_leaves(tree, is_leaf=_is_packed):
        if leaf is None:
            continue
        if _is_packed(leaf):
            total += leaf["q"].numel() + leaf["scale"].numel() * 4
        else:
            arr = torch.as_tensor(leaf)
            total += arr.numel() * arr.element_size()
    return total
