"""K2's backward in a model whose attention layers differ in kind,
against its frozen bound a call averaged over the layer pattern
(``_swa``): a call is three or four CUDA launches of these kernels (the
row sums, dK/dV, dQ, and the split heads' sum)."""

from perfbench.metrics import _swa
from perfbench.metrics._roofline import shape, share

KERNELS = r"\bbwd_(dot|dkdv_(cc|tc|wide|wgmma|sum)|dq_(cc|tc|wide|wgmma))\b"


def read(window):
    B, T, m = shape(window)
    if m["family"] == "rwkv" or not m.get("window"):
        return None
    return share(window, "flash_attention_bwd", KERNELS,
                 _swa.mean_bound(m, B, T, _swa.k2_bwd))
