"""Kernels without a backward refuse inputs that need a gradient.

Each wrapper fills a ``torch.empty`` output through ``ctypes``, which
autograd cannot see through: an input that requires grad would come out of
the kernel cut from its graph, and ``backward`` would leave its gradient at
nothing without a word.  K2 ``flash_attention`` has a backward kernel
(``flash_attention.FlashAttention``).  K3 ``moe_gmm``, K4 ``rwkv_scan`` and
K5 ``rglru_scan`` have none yet, and K1 ``decode_attention`` is decode only:
their ``check`` calls ``refuse_grad`` first and raises instead.  CPU
tensors take the plain versions in ``ref`` (``ops`` dispatches by device),
which differentiate as usual.
"""

from __future__ import annotations

import torch


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise ``RuntimeError`` if grad mode is on and one of ``tensors``
    (``None`` entries skipped) requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, but this kernel has no "
            "backward yet (only flash_attention has one; moe_gmm, "
            "rwkv_scan and rglru_scan wait for theirs, decode_attention is "
            "decode only), so it would drop the gradient; run it under "
            "torch.no_grad() or on CPU tensors (the plain path "
            "differentiates)")
