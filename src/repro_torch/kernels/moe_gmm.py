"""K3 ``moe_gmm`` on the card: the wrapper of ``csrc/moe_gmm.cu``
(replaces the Pallas TPU kernel ``src/repro/kernels/moe_gmm.py``).

The wrapper checks its inputs and raises on anything the kernel does not
take, allocates the output, launches on the current stream and counts the
launch.  It runs only on CUDA tensors: ``ops.moe_gmm`` sends CPU tensors to
``ref.moe_gmm`` instead.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._grad import refuse_grad

ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}

launches = 0                    # kernel launches since the last reset
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("moe_gmm").repro_moe_gmm
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check(x, w, rows=None) -> None:
    """Raise ``RuntimeError`` for an input that would need a gradient
    (``refuse_grad``), ``ValueError`` unless the kernel takes these inputs."""
    refuse_grad("moe_gmm", x, w)
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"want x (E,C,D), w (E,D,F); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if min(x.shape) < 1 or w.shape[2] < 1 or x.shape[0] > 65535:
        raise ValueError(f"shapes {tuple(x.shape)}, {tuple(w.shape)}: want "
                         "nonempty, E <= 65535")
    if x.dtype not in ELEM_BYTES or w.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}/{w.dtype}: want both float32 or "
                         "both bfloat16")
    if x.stride(-1) != 1 or w.stride(-1) != 1:
        raise ValueError("x and w must have a unit stride on their last dim")
    if rows is not None and (rows.shape != (x.shape[0],)
                             or rows.dtype != torch.int32
                             or not rows.is_contiguous()):
        raise ValueError(f"rows must be ({x.shape[0]},) int32 and "
                         f"contiguous; got {tuple(rows.shape)} {rows.dtype}")
    if not x.is_cuda or any(t.device != x.device for t in
                            (w,) + (() if rows is None else (rows,))):
        raise ValueError("all inputs must be on one CUDA device")


def moe_gmm(x, w, rows=None):
    """x: (E,C,D); w: (E,D,F), both read through their strides (a layer's
    view of a stacked leaf is fine) -> y (E,C,F) in x.dtype, each product
    summed in float32 over all of D.  ``rows`` (E,) int32 on the device, or
    None for all C: rows c >= rows[e] of y are zeros, and no weight is read
    for them."""
    global launches
    check(x, w, rows)
    E, C, D = x.shape
    F = w.shape[2]
    y = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    strides = (ctypes.c_longlong * 6)(x.stride(0), x.stride(1), w.stride(0),
                                      w.stride(1), y.stride(0), y.stride(1))
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(ELEM_BYTES[x.dtype], x.data_ptr(), w.data_ptr(), y.data_ptr(),
                None if rows is None else rows.data_ptr(), E, C, D, F,
                strides, stream)
    if rc != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed: cudaError_t {rc}")
    launches += 1
    return y
