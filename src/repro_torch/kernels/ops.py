"""Public kernel entry points, dispatched by device.

A CUDA tensor goes to the hand-written kernel (built at first use), a CPU
tensor to its plain version in ``ref``; any other device raises.  There is
no fallback: a kernel that cannot take a CUDA input raises.  This is the
counterpart of ``repro.kernels.ops``, where non-TPU backends run the Pallas
kernels in interpret mode.
"""

from __future__ import annotations

from . import decode_attention as _decode
from . import flash_attention as _flash
from . import ref

KERNELS = {"decode_attention": _decode, "flash_attention": _flash}


def _on(t) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {t.device}")
    return t.device.type


def flash_attention(q, k, v, causal: bool = True):
    """q: (B,H,T,hd); k,v: (B,Hkv,S,hd) -> (B,H,T,hd)."""
    if _on(q) == "cuda":
        return _flash.flash_attention(q, k, v, causal=causal)
    return ref.attention(q, k, v, causal=causal)


def decode_attention(q, k, v, lengths):
    """q: (B,H,hd); k,v: (B,Hkv,S,hd); lengths: (B,) int32 -> (B,H,hd)."""
    if _on(q) == "cuda":
        return _decode.decode_attention(q, k, v, lengths)
    return ref.decode_attention(q, k, v, lengths)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last ``reset_launch_counts``."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
