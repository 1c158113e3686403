"""K4's forward (``rwkv_scan``) against its frozen bound, the
recurrence's own work with no chunk term; a call is three CUDA
launches."""

from perfbench import counts
from perfbench.metrics._roofline import bound, shape, share

KERNELS = r"\b(chunk_state|state_scan|chunk_out)\b"


def read(window):
    B, T, m = shape(window)
    if m["family"] != "rwkv":
        return None
    M = m["rwkv_head_dim"]
    b = bound(counts.k4_fwd(B, m["d_model"] // M, T, M))
    return share(window, "rwkv_scan", KERNELS, b)
