"""K3's forward (``moe_gmm``) against its frozen bound, counted over the
routed (token, expert) pairs, tokens x top-k, and every expert's weights
read once (at these batches every expert receives tokens).  A layer's
pass is three calls: gate and up (d -> f), then down (f -> d)."""

from perfbench import counts
from perfbench.metrics._roofline import bound, shape, share

KERNELS = r"\bmoe_gmm_(kernel|ffma|tc|wgmma)\b"


def read(window):
    B, T, m = shape(window)
    if not m.get("n_experts"):
        return None
    pairs, E, d, f = B * T * m["top_k"], m["n_experts"], m["d_model"], \
        m["moe_d_ff"]
    b = (2 * bound(counts.k3_fwd(pairs, E, d, f))
         + bound(counts.k3_fwd(pairs, E, f, d))) / 3
    return share(window, "moe_gmm", KERNELS, b)
