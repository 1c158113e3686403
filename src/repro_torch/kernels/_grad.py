"""The CUDA kernels have no backward yet.

Each wrapper fills a ``torch.empty`` output through ``ctypes``, which
autograd cannot see through: an input that requires grad would come out of
the kernel cut from its graph, and ``backward`` would leave its gradient at
nothing without a word.  So each wrapper's ``check`` calls ``refuse_grad``
first and raises instead.  CPU tensors take the plain versions in ``ref``
(``ops`` dispatches by device), which differentiate as usual.
"""

from __future__ import annotations

import torch


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise ``RuntimeError`` if grad mode is on and one of ``tensors``
    (``None`` entries skipped) requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, but the port has no "
            "backward kernels yet, so the CUDA kernel would drop its "
            "gradient; run it under torch.no_grad() or on CPU tensors "
            "(the plain path differentiates)")
