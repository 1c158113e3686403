"""K5 ``rglru_scan`` on the card: the wrapper of ``csrc/rglru_scan.cu``
(replaces the Pallas TPU kernel ``src/repro/kernels/rglru_scan.py``).

The wrapper checks its inputs and raises on anything the kernel does not
take, allocates the output, launches on the current stream and counts the
launch.  It runs only on CUDA tensors: ``ops.rglru_scan`` sends CPU
tensors to ``ref.rglru_scan`` instead.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._grad import refuse_grad

launches = 0                    # kernel launches since the last reset
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("rglru_scan").repro_rglru_scan
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check(a, b) -> None:
    """Raise ``RuntimeError`` for an input that would need a gradient
    (``refuse_grad``), ``ValueError`` unless the kernel takes these inputs."""
    refuse_grad("rglru_scan", a, b)
    if a.dim() != 3 or b.shape != a.shape or min(a.shape) < 1:
        raise ValueError(f"want a, b (B,T,D) of one nonempty shape; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.shape[0] > 65535:
        raise ValueError(f"B = {a.shape[0]}: want at most 65535")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"dtypes {a.dtype}/{b.dtype}: want float32")
    if a.stride(-1) != 1 or b.stride(-1) != 1:
        raise ValueError("a and b must have a unit stride on D")
    if not a.is_cuda or b.device != a.device:
        raise ValueError("all inputs must be on one CUDA device")


def rglru_scan(a, b):
    """a, b: (B,T,D) float32, read through their strides -> h (B,T,D)
    float32 with h_t = a_t h_{t-1} + b_t from h_{-1} = 0."""
    global launches
    check(a, b)
    B, T, D = a.shape
    h = torch.empty((B, T, D), dtype=torch.float32, device=a.device)
    strides = (ctypes.c_longlong * 6)(a.stride(0), a.stride(1), b.stride(0),
                                      b.stride(1), h.stride(0), h.stride(1))
    fn = _kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, T, D, strides,
                stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: "
                           f"cudaError_t {rc}")
    launches += 1
    return h
