"""K1 ``decode_attention`` on the card: the wrapper of
``csrc/decode_attention.cu`` (replaces the Pallas TPU kernel
``src/repro/kernels/decode_attention.py``).

The wrapper checks its inputs and raises on anything the kernel does not
take, allocates the output, launches on the current stream and counts the
launch.  It runs only on CUDA tensors: ``ops.decode_attention`` sends CPU
tensors to ``ref.decode_attention`` instead.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP_ELEMS = 2048          # G * hd: the kernel's register accumulators

launches = 0                    # kernel launches since the last reset
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("decode_attention").repro_decode_attention
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check(q, k, v, lengths) -> None:
    """Raise ``ValueError`` unless the kernel takes these inputs."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,H,hd), k/v (B,Hkv,S,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)}")
    if (H // k.shape[1]) * hd > MAX_GROUP_ELEMS:
        raise ValueError(f"G*hd = {(H // k.shape[1]) * hd} > "
                         f"{MAX_GROUP_ELEMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: want all "
                         "float32 or all bfloat16")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be (B,) int32")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit head-dim stride")
    for t in (q, k, v, lengths):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("all inputs must be on one CUDA device")


def decode_attention(q, k, v, lengths):
    """q: (B,H,hd); k,v: (B,Hkv,S,hd) read through their strides (a permuted
    view of a (B,S,Hkv,hd) cache is fine); lengths: (B,) int32 on the same
    device -> (B,H,hd) in q.dtype.  Positions >= lengths[b] are masked."""
    global launches
    check(q, k, v, lengths)
    B, H, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    lengths = lengths.contiguous()
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1))
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), B, H, Hkv, S, hd, strides,
                stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError_t {rc}")
    launches += 1
    return out
