"""K3's backward against its frozen bound over the kept pairs
(``_kept``), as ``k3_kept_fwd_roofline``; a call is two CUDA launches
(dx, dw)."""

from perfbench import counts
from perfbench.metrics import _kept
from perfbench.metrics._roofline import share

KERNELS = r"\bgmm_bwd_(tc|ffma|wgmma)\b"


def read(window):
    b = _kept.mean_bound(window, counts.k3_bwd)
    return None if b is None else share(window, "moe_gmm_bwd", KERNELS, b)
