"""K2 ``flash_attention`` on the card: the wrapper of
``csrc/flash_attention.cu`` (replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py``).

The wrapper checks its inputs and raises on anything the kernel does not
take, allocates the output, launches on the current stream and counts the
launch.  It runs only on CUDA tensors: ``ops.flash_attention`` sends CPU
tensors to ``ref.attention`` instead.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)  # instantiated in the CUDA source

launches = 0                    # kernel launches since the last reset
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").repro_flash_attention
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check(q, k, v, causal: bool) -> None:
    """Raise ``ValueError`` unless the kernel takes these inputs."""
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


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B,H,T,hd); k,v: (B,Hkv,S,hd), all read through their strides ->
    (B,H,T,hd) in q.dtype.  The causal mask is bottom-right aligned (query
    i sees key j when j <= i + S - T), as in ``ref.attention``."""
    global launches
    check(q, k, v, causal)
    B, H, T, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out = torch.empty((B, H, T, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
        k.stride(2), v.stride(0), v.stride(1), v.stride(2), out.stride(0),
        out.stride(1), out.stride(2))
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), B, H, Hkv, T, S, hd, int(causal), strides,
                stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {rc}")
    launches += 1
    return out
