"""K2's backward against its frozen bound: a call is three or four CUDA
launches of these kernels (the row sums, dK/dV, dQ, and the split
heads' sum)."""

from perfbench import counts
from perfbench.metrics._roofline import bound, shape, share

KERNELS = r"\bbwd_(dot|dkdv_(cc|tc|wide|wgmma|sum)|dq_(cc|tc|wide|wgmma))\b"


def read(window):
    B, T, m = shape(window)
    if m["family"] == "rwkv":
        return None
    b = bound(counts.k2_bwd(B, m["n_heads"], m["n_kv_heads"], T,
                            m["head_dim"]))
    return share(window, "flash_attention_bwd", KERNELS, b)
