"""K5 ``rglru_scan`` on the card: the wrapper of ``csrc/rglru_scan.cu``
(replaces the Pallas TPU kernel ``src/repro/kernels/rglru_scan.py``) and
of its backward, ``csrc/rglru_scan_bwd.cu``.

The wrapper checks its inputs and raises on anything the kernel does not
take, allocates the output, launches on the current stream and counts the
launch.  It runs only on CUDA tensors: ``ops.rglru_scan`` sends CPU
tensors to ``ref.rglru_scan`` instead.  Under grad mode, with an input
that requires grad, the call goes through ``RGLRUScan``, whose backward
launches the backward kernel.

A fake tensor (a trace on ``FakeTensorMode``, inside
``cost.card_path()``) gets its outputs allocated and its call recorded in
``cost``, with ``cost.py``'s count of its work; nothing is launched or
counted as a launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, cost

launches = 0                    # forward launches since the last reset
bwd_launches = 0                # backward launches since the last reset
_fn = None
_bwd_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("rglru_scan").repro_rglru_scan
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load("rglru_scan_bwd").repro_rglru_scan_bwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def check(a, b) -> None:
    """Raise ``ValueError`` unless the kernel takes these inputs.  An input
    that requires grad is taken: ``rglru_scan`` differentiates it."""
    if a.dim() != 3 or b.shape != a.shape or min(a.shape) < 1:
        raise ValueError(f"want a, b (B,T,D) of one nonempty shape; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.shape[0] > 65535:
        raise ValueError(f"B = {a.shape[0]}: want at most 65535")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"dtypes {a.dtype}/{b.dtype}: want float32")
    if a.stride(-1) != 1 or b.stride(-1) != 1:
        raise ValueError("a and b must have a unit stride on D")
    if not cost.on_card(a) or b.device != a.device:
        raise ValueError("all inputs must be on one CUDA device")


def _bt(*ts):
    """The batch and time strides of each (B, T, D) tensor, as a C array."""
    flat = [t.stride(i) for t in ts for i in range(2)]
    return (ctypes.c_longlong * len(flat))(*flat)


def forward(a, b):
    """One K5 launch on checked inputs -> h (B,T,D) float32."""
    global launches
    B, T, D = a.shape
    h = torch.empty((B, T, D), dtype=torch.float32, device=a.device)
    if cost.is_fake(a):                 # a trace: count it, launch nothing
        cost.record("rglru_scan", B=B, T=T, D=D)
        return h
    fn = _kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, T, D,
                _bt(a, b, h), stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: "
                           f"cudaError_t {rc}")
    launches += 1
    return h


def backward(a, h, dh):
    """K5's backward on the card: (da, db) (B,T,D) float32 from ``a``, the
    forward's output ``h`` and the gradient ``dh`` of ``h``, each read
    through its batch and time strides (unit stride on D): g_t = dh_t +
    a_{t+1} g_{t+1}, da_t = g_t h_{t-1}, db_t = g_t.  One launch."""
    global bwd_launches
    check(a, h)
    if dh.shape != a.shape or dh.dtype != torch.float32 \
            or dh.device != a.device or dh.stride(-1) != 1:
        raise ValueError(f"dh {tuple(dh.shape)} {dh.dtype}: want "
                         f"{tuple(a.shape)} float32 on {a.device} with a "
                         "unit stride on D")
    B, T, D = a.shape
    da = torch.empty((B, T, D), dtype=torch.float32, device=a.device)
    db = torch.empty_like(da)
    if cost.is_fake(a):                 # a trace: count it, launch nothing
        cost.record("rglru_scan_bwd", B=B, T=T, D=D)
        return da, db
    fn = _bwd_kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
                db.data_ptr(), B, T, D, _bt(a, h, dh, da, db), stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan backward launch failed: "
                           f"cudaError_t {rc}")
    bwd_launches += 1
    return da, db


class RGLRUScan(torch.autograd.Function):
    """K5 with its backward kernel: the forward launches K5 and keeps ``a``
    and ``h``; the backward launches ``csrc/rglru_scan_bwd.cu``.  A ``dh``
    without a unit stride on D (an expanded gradient) is made contiguous
    first; any other ``dh`` is read through its strides."""

    @staticmethod
    def forward(ctx, a, b):
        h = forward(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        if dh.stride(-1) != 1:
            dh = dh.contiguous()
        return backward(a, h, dh)


def rglru_scan(a, b):
    """a, b: (B,T,D) float32, read through their strides -> h (B,T,D)
    float32 with h_t = a_t h_{t-1} + b_t from h_{-1} = 0.  Under grad mode
    with an input that requires grad, the result carries K5's backward
    kernel (``RGLRUScan``)."""
    check(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return RGLRUScan.apply(a, b)
    return forward(a, b)
