"""K4 ``rwkv_scan`` on the card: the wrapper of ``csrc/rwkv_scan.cu``
(replaces the Pallas TPU kernel ``src/repro/kernels/rwkv_scan.py``).

The wrapper checks its inputs and raises on anything the kernel does not
take, allocates the outputs (and, for T > 1, the float32 scratch of the
chunk states), launches on the current stream and counts the call: one
launch for T == 1, three for a prefill (chunk states, the scan over them,
the chunk outputs), all from one C call.  It runs only on CUDA tensors: ``ops.rwkv_scan`` sends CPU tensors
to ``ref.rwkv_scan`` instead.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._grad import refuse_grad

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_SIZE = 64              # M: the kernel's shared-memory tiles
CHUNK = 64                      # csrc/rwkv_scan.cu kC

launches = 0                    # kernel launches since the last reset
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("rwkv_scan").repro_rwkv_scan
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check(r, k, v, logw, u, S0=None) -> None:
    """Raise ``RuntimeError`` for an input that would need a gradient
    (``refuse_grad``), ``ValueError`` unless the kernel takes these inputs."""
    refuse_grad("rwkv_scan", r, k, v, logw, u, S0)
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"want r/k/v/logw (B,H,T,M) of one shape; got "
                         f"{[tuple(t.shape) for t in (r, k, v, logw)]}")
    B, H, T, M = r.shape
    if T < 1 or not 1 <= M <= MAX_HEAD_SIZE:
        raise ValueError(f"want T >= 1 and 1 <= M <= {MAX_HEAD_SIZE}; got "
                         f"T={T}, M={M}")
    if u.shape != (H, M) or not u.is_contiguous():
        raise ValueError(f"u must be ({H},{M}) and contiguous; got "
                         f"{tuple(u.shape)}")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"dtypes {r.dtype}/{k.dtype}/{v.dtype}: want r/k/v "
                         "all float32 or all bfloat16")
    if logw.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError("logw and u must be float32")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit stride on M")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H}: want at most 65535")
    if S0 is not None:
        if S0.shape != (B, H, M, M) or S0.dtype != torch.float32:
            raise ValueError(f"S0 must be ({B},{H},{M},{M}) float32")
        if S0.stride(-1) != 1 or S0.stride(-2) != M:
            raise ValueError("each (M, M) state of S0 must be contiguous")
    for t in (r, k, v, logw, u) + (() if S0 is None else (S0,)):
        if not t.is_cuda or t.device != r.device:
            raise ValueError("all inputs must be on one CUDA device")


def rwkv_scan(r, k, v, logw, u, S0=None):
    """r,k,v: (B,H,T,M) float32 or bf16; logw: (B,H,T,M) float32 (<= 0);
    u: (H,M) float32; S0: (B,H,M,M) float32 or None (zeros) -> (o
    (B,H,T,M) float32, a view of a (B,T,H,M) buffer; S (B,H,M,M)
    float32).  Every input is read through its strides."""
    global launches
    check(r, k, v, logw, u, S0)
    B, H, T, M = r.shape
    o = torch.empty((B, T, H, M), dtype=torch.float32,
                    device=r.device).transpose(1, 2)
    S = torch.empty((B, H, M, M), dtype=torch.float32, device=r.device)
    buf = dec = None
    if T > 1:                   # per chunk: its state delta, then its start
        nc = -(-T // CHUNK)
        buf = torch.empty((B * H, nc, MAX_HEAD_SIZE, MAX_HEAD_SIZE),
                          dtype=torch.float32, device=r.device)
        dec = torch.empty((B * H, nc, MAX_HEAD_SIZE), dtype=torch.float32,
                          device=r.device)
    s0 = (0, 0) if S0 is None else (S0.stride(0), S0.stride(1))
    strides = (ctypes.c_longlong * 19)(
        *(t.stride(i) for t in (r, k, v, logw, o) for i in range(3)),
        *s0, S.stride(0), S.stride(1))
    fn = _kernel()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = fn(DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
                logw.data_ptr(), u.data_ptr(),
                None if S0 is None else S0.data_ptr(), o.data_ptr(),
                S.data_ptr(), None if buf is None else buf.data_ptr(),
                None if dec is None else dec.data_ptr(), B, H, T, M, strides,
                stream)
    if rc != 0:
        raise RuntimeError(f"rwkv_scan kernel launch failed: cudaError_t {rc}")
    launches += 1
    return o, S
