"""K3's forward (``moe_gmm``) against its frozen bound over the pairs
the experts kept (``_kept``), where ``k3_fwd_roofline`` counts every
routed pair: at a cell whose capacity drops most pairs, that count
reads above what the kernel can reach."""

from perfbench import counts
from perfbench.metrics import _kept
from perfbench.metrics._roofline import share

KERNELS = r"\bmoe_gmm_(kernel|ffma|tc|wgmma)\b"


def read(window):
    b = _kept.mean_bound(window, counts.k3_fwd)
    return None if b is None else share(window, "moe_gmm", KERNELS, b)
