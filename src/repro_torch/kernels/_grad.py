"""A kernel without a backward refuses inputs that need a gradient.

Each wrapper fills a ``torch.empty`` output through ``ctypes``, which
autograd cannot see through: an input that requires grad would come out of
the kernel cut from its graph, and ``backward`` would leave its gradient at
nothing without a word.  K2 ``flash_attention``, K3 ``moe_gmm``, K4
``rwkv_scan`` and K5 ``rglru_scan`` have backward kernels (each behind a
``torch.autograd.Function`` in its wrapper).  K1 ``decode_attention`` is
decode only and has none: its ``check`` calls ``refuse_grad`` first and
raises instead.  CPU tensors take the plain versions in ``ref`` (``ops``
dispatches by device), which differentiate as usual.
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
            "backward (it is decode only; flash_attention, moe_gmm, "
            "rwkv_scan and rglru_scan have backward kernels), so it would "
            "drop the gradient; run it under torch.no_grad() or on CPU "
            "tensors (the plain path differentiates)")
