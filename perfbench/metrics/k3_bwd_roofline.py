"""K3's backward against its frozen bound, over the routed pairs as
``k3_fwd_roofline``; a call is two CUDA launches (dx, dw)."""

from perfbench import counts
from perfbench.metrics._roofline import bound, shape, share

KERNELS = r"\bgmm_bwd_(tc|ffma|wgmma)\b"


def read(window):
    B, T, m = shape(window)
    if not m.get("n_experts"):
        return None
    pairs, E, d, f = B * T * m["top_k"], m["n_experts"], m["d_model"], \
        m["moe_d_ff"]
    b = (2 * bound(counts.k3_bwd(pairs, E, d, f))
         + bound(counts.k3_bwd(pairs, E, f, d))) / 3
    return share(window, "moe_gmm_bwd", KERNELS, b)
