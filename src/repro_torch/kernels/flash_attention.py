"""K2 ``flash_attention`` on the card: the wrapper of
``csrc/flash_attention.cu`` (replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py``) and of its backward,
``csrc/flash_attention_bwd.cu``.

The wrapper checks its inputs and raises on anything the kernel does not
take, allocates the outputs, launches on the current stream and counts the
launch.  It runs only on CUDA tensors: ``ops.flash_attention`` sends CPU
tensors to ``ref.attention`` instead.  Under grad mode, with an input that
requires grad, the call goes through ``FlashAttention``: its forward
launches K2 with ``lse`` and its backward launches the backward kernel, so
the gradient on the card is a kernel's too.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 160, 256)  # instantiated in the CUDA sources

launches = 0                    # forward launches since the last reset
bwd_launches = 0                # backward calls (three CUDA launches each)
_fn = None
_bwd_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").repro_flash_attention
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 8
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load("flash_attention_bwd").repro_flash_attention_bwd
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 8
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def check(q, k, v, causal: bool, window: int = 0) -> None:
    """Raise ``ValueError`` unless the kernel takes these inputs.  An input
    that requires grad is taken: ``flash_attention`` differentiates it."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,H,T,hd), k/v (B,Hkv,S,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, T, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if window < 0 or (window and not causal):
        raise ValueError(f"window {window}: want 0, or > 0 with causal")
    if causal and T > k.shape[2]:
        raise ValueError(f"causal attention needs T <= S; got T={T}, "
                         f"S={k.shape[2]}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: want all "
                         "float32 or all bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit head-dim stride")
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("all inputs must be on one CUDA device")


def _strides(*ts):
    """The batch, head and row strides of each (B, heads, rows, hd) tensor,
    as the C array the kernels take."""
    flat = [t.stride(i) for t in ts for i in range(3)]
    return (ctypes.c_longlong * len(flat))(*flat)


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def forward(q, k, v, causal: bool, window: int, with_lse: bool):
    """One K2 launch on checked inputs -> (out (B,H,T,hd) in q.dtype, lse
    (B,H,T) float32, or None unless ``with_lse``)."""
    global launches
    B, H, T, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out = torch.empty((B, H, T, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) \
        if with_lse else None
    fn = _kernel()
    with torch.cuda.device(q.device):
        rc = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), None if lse is None else lse.data_ptr(), B,
                H, Hkv, T, S, hd, int(causal), window,
                _strides(q, k, v, out), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {rc}")
    launches += 1
    return out, lse


def backward(q, k, v, out, lse, dout, *, causal: bool = True,
             window: int = 0):
    """K2's backward on the card: (dq (B,H,T,hd), dk, dv (B,Hkv,S,hd)) in
    q.dtype, from K2's inputs, its ``out`` and ``lse`` and the gradient
    ``dout`` of ``out``, each read through its strides.  Three CUDA
    launches: D = rowsum(dout * out), then dk / dv, then dq (the formula of
    ``ref.attention_backward``)."""
    global bwd_launches
    check(q, k, v, causal, window)
    B, H, T, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or t.stride(-1) != 1):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: want "
                             f"{tuple(q.shape)} {q.dtype} on {q.device} with "
                             "a unit head-dim stride")
    if (lse.shape != (B, H, T) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: want "
                         f"contiguous float32 {(B, H, T)}")
    dq = torch.empty((B, H, T, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Hkv, S, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    D = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    fn = _bwd_kernel()
    with torch.cuda.device(q.device):
        rc = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                D.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B,
                H, Hkv, T, S, hd, int(causal), window,
                _strides(q, k, v, out, dout), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: "
                           f"cudaError_t {rc}")
    bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K2 with its backward kernel: the forward launches K2 and keeps
    ``q, k, v, out, lse``; the backward launches the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = forward(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = backward(q, k, v, out, lse, dout, causal=ctx.causal,
                              window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,H,T,hd); k,v: (B,Hkv,S,hd), all read through their strides ->
    (B,H,T,hd) in q.dtype.  The causal mask is bottom-right aligned (query
    i sees key j when j <= i + S - T), as in ``ref.attention``; a
    ``window`` > 0 also drops keys j <= i + S - T - window.  Under grad
    mode with an input that requires grad, the result carries K2's
    backward kernel (``FlashAttention``)."""
    check(q, k, v, causal, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    return forward(q, k, v, causal, window, with_lse=False)[0]
