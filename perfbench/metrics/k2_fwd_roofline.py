"""K2's forward (``flash_attention``) against its frozen bound: each call
is one CUDA launch of one of these kernels."""

from perfbench import counts
from perfbench.metrics._roofline import bound, shape, share

KERNELS = r"\bflash_attention_(kernel|tc)\b"


def read(window):
    B, T, m = shape(window)
    if m["family"] == "rwkv":
        return None
    b = bound(counts.k2_fwd(B, m["n_heads"], m["n_kv_heads"], T,
                            m["head_dim"]))
    return share(window, "flash_attention", KERNELS, b)
