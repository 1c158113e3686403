"""K4's backward against its frozen bound (no chunk-start states); a
call is four CUDA launches."""

from perfbench import counts
from perfbench.metrics._roofline import bound, shape, share

KERNELS = r"\brwkv_bwd_\w+"


def read(window):
    B, T, m = shape(window)
    if m["family"] != "rwkv":
        return None
    M = m["rwkv_head_dim"]
    b = bound(counts.k4_bwd(B, m["d_model"] // M, T, M))
    return share(window, "rwkv_scan_bwd", KERNELS, b)
