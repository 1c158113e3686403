"""K2's forward in a model whose attention layers differ in kind, against
its frozen bound a call averaged over the layer pattern (``_swa``): a
windowed call counts its window's pairs, a full call its causal pairs.
Each call is one CUDA launch of one of these kernels."""

from perfbench.metrics import _swa
from perfbench.metrics._roofline import shape, share

KERNELS = r"\bflash_attention_(kernel|tc)\b"


def read(window):
    B, T, m = shape(window)
    if m["family"] == "rwkv" or not m.get("window"):
        return None
    return share(window, "flash_attention", KERNELS,
                 _swa.mean_bound(m, B, T, _swa.k2_fwd))
