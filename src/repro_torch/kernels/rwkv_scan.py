"""K4 ``rwkv_scan`` on the card: the wrapper of ``csrc/rwkv_scan.cu``
(replaces the Pallas TPU kernel ``src/repro/kernels/rwkv_scan.py``).

The wrapper checks its inputs and raises on anything the kernel does not
take, allocates the outputs (and, for T > 1, the float32 scratch of the
chunk states), launches on the current stream and counts the call: one
launch for T == 1, three for a prefill (chunk states, the scan over them,
the chunk outputs), all from one C call.  It runs only on CUDA tensors:
``ops.rwkv_scan`` sends CPU tensors to ``ref.rwkv_scan`` instead.  Under
grad mode, with an input that requires grad, the call goes through
``RWKVScan``: its forward keeps the chunk states the forward wrote into its
scratch, and its backward launches ``csrc/rwkv_scan_bwd.cu``.

A fake tensor (a trace on ``FakeTensorMode``, inside
``cost.card_path()``) gets its outputs allocated and its call recorded in
``cost``, with ``cost.py``'s count of its work; nothing is launched or
counted as a launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, cost

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_SIZE = 64              # M: the kernel's shared-memory tiles
CHUNK = 64                      # csrc/rwkv_scan.cu kC

launches = 0                    # forward calls since the last reset
bwd_launches = 0                # backward calls (four CUDA launches each)
# backward calls by kernels since the last reset: "tc" (bf16, the chunk
# products on the tensor cores in split bf16) and "cc" (CUDA cores, the
# float32 calls); see ``_bwd_route``
bwd_routes = {"tc": 0, "cc": 0}
_fn = None
_bwd_fn = None


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


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load("rwkv_scan_bwd").repro_rwkv_scan_bwd
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 18
                       + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def check(r, k, v, logw, u, S0=None) -> None:
    """Raise ``ValueError`` unless the kernel takes these inputs.  An input
    that requires grad is taken: ``rwkv_scan`` differentiates it."""
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
        if not cost.on_card(t) or t.device != r.device:
            raise ValueError("all inputs must be on one CUDA device")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _heads_view(B, H, T, M, dtype, device):
    """An empty (B,H,T,M) view of a (B,T,H,M) buffer, the model's layout."""
    return torch.empty((B, T, H, M), dtype=dtype,
                       device=device).transpose(1, 2)


def forward(r, k, v, logw, u, S0=None):
    """One K4 call on checked inputs -> (o, S, states): states is the
    float32 scratch (B*H, chunks, 64, 64) holding each chunk's start state
    after the call, or None for T == 1."""
    global launches
    B, H, T, M = r.shape
    o = _heads_view(B, H, T, M, torch.float32, r.device)
    S = torch.empty((B, H, M, M), dtype=torch.float32, device=r.device)
    buf = dec = None
    if T > 1:                   # per chunk: its state delta, then its start
        nc = -(-T // CHUNK)
        buf = torch.empty((B * H, nc, MAX_HEAD_SIZE, MAX_HEAD_SIZE),
                          dtype=torch.float32, device=r.device)
        dec = torch.empty((B * H, nc, MAX_HEAD_SIZE), dtype=torch.float32,
                          device=r.device)
    if cost.is_fake(r):                 # a trace: count it, launch nothing
        cost.record("rwkv_scan", B=B, H=H, T=T, M=M, dtype=r.dtype,
                    S0=S0 is not None)
        return o, S, buf
    s0 = (0, 0) if S0 is None else (S0.stride(0), S0.stride(1))
    strides = (ctypes.c_longlong * 19)(
        *(t.stride(i) for t in (r, k, v, logw, o) for i in range(3)),
        *s0, S.stride(0), S.stride(1))
    fn = _kernel()
    with torch.cuda.device(r.device):
        rc = fn(DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
                logw.data_ptr(), u.data_ptr(), _ptr(S0), o.data_ptr(),
                S.data_ptr(), _ptr(buf), _ptr(dec), B, H, T, M, strides,
                _stream(r))
    if rc != 0:
        raise RuntimeError(f"rwkv_scan kernel launch failed: cudaError_t {rc}")
    launches += 1
    return o, S, buf


def _bwd_route(r) -> str:
    """The backward kernels a call takes, chosen before the launch: "tc"
    (tensor cores) for bf16 r, k, v, "cc" (CUDA cores, float32 products)
    for float32, whose callers are parity checks."""
    return "tc" if r.dtype == torch.bfloat16 else "cc"


def backward(r, k, v, logw, u, S0, states, do, dS=None):
    """K4's backward on the card, from K4's inputs, the chunk-start
    ``states`` its forward left (None for T == 1), the gradient ``do``
    (B,H,T,M) float32 of o and ``dS`` (B,H,M,M) float32 of the final state
    (None: zeros) -> (dr, dk, dv in r.dtype, as (B,H,T,M) views of
    (B,T,H,M) buffers; dlogw float32, the same; du (H,M) float32, summed
    over b and t; dS0 (B,H,M,M) float32, or None without S0).  Every
    input is read through its strides.  Four CUDA launches, of the kernels
    ``_bwd_route`` picks: each chunk's q_in^T do, the scan of the
    chunk-state gradients from the last chunk back, each chunk's
    gradients, the sum of du."""
    global bwd_launches
    check(r, k, v, logw, u, S0)
    B, H, T, M = r.shape
    nc = -(-T // CHUNK)
    if do.shape != r.shape or do.dtype != torch.float32 \
            or do.device != r.device or do.stride(-1) != 1:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype}: want "
                         f"{tuple(r.shape)} float32 on {r.device} with a "
                         "unit stride on M")
    if dS is not None and (dS.shape != (B, H, M, M)
                           or dS.dtype != torch.float32
                           or dS.stride(-1) != 1 or dS.stride(-2) != M):
        raise ValueError(f"dS must be ({B},{H},{M},{M}) float32 with "
                         "contiguous states")
    want = (B * H, nc, MAX_HEAD_SIZE, MAX_HEAD_SIZE)
    if (states is None) != (T == 1) or states is not None and (
            tuple(states.shape) != want or not states.is_contiguous()):
        raise ValueError(f"states: want contiguous float32 {want} for T > 1"
                         ", None for T == 1")
    dr, dk, dv = (_heads_view(B, H, T, M, r.dtype, r.device)
                  for _ in range(3))
    dlogw = _heads_view(B, H, T, M, torch.float32, r.device)
    du = torch.empty((H, M), dtype=torch.float32, device=r.device)
    dS0 = torch.empty((B, H, M, M), dtype=torch.float32, device=r.device) \
        if S0 is not None else None
    if cost.is_fake(r):                 # a trace: count it, launch nothing
        cost.record("rwkv_scan_bwd", B=B, H=H, T=T, M=M, dtype=r.dtype,
                    S0=S0 is not None, dS=dS is not None)
        return dr, dk, dv, dlogw, du, dS0
    f32 = dict(dtype=torch.float32, device=r.device)
    dsend = torch.empty(want, **f32)
    dec = torch.empty((B * H, nc, MAX_HEAD_SIZE), **f32)
    du_part = torch.empty((B * H, nc, MAX_HEAD_SIZE), **f32)

    def bh(t):
        return (0, 0) if t is None else (t.stride(0), t.stride(1))
    strides = (ctypes.c_longlong * 33)(
        *(t.stride(i) for t in (r, k, v, logw, do, dr, dk, dv, dlogw)
          for i in range(3)), *bh(dS), *bh(S0), *bh(dS0))
    route = _bwd_route(r)
    fn = _bwd_kernel()
    with torch.cuda.device(r.device):
        rc = fn(DTYPES[r.dtype], int(route == "tc"), r.data_ptr(),
                k.data_ptr(), v.data_ptr(),
                logw.data_ptr(), u.data_ptr(), _ptr(S0), _ptr(states),
                do.data_ptr(), _ptr(dS), dr.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), dlogw.data_ptr(), du.data_ptr(), _ptr(dS0),
                dsend.data_ptr(), dec.data_ptr(), du_part.data_ptr(), B, H,
                T, M, strides, _stream(r))
    if rc != 0:
        raise RuntimeError(f"rwkv_scan backward launch failed ({route}): "
                           f"cudaError_t {rc}")
    bwd_launches += 1
    bwd_routes[route] += 1
    return dr, dk, dv, dlogw, du, dS0


class RWKVScan(torch.autograd.Function):
    """K4 with its backward kernel: the forward launches K4 and keeps its
    inputs and the chunk-start states of its scratch (B*H*chunks*64*64
    float32, so the backward recomputes nothing); the backward launches
    ``csrc/rwkv_scan_bwd.cu``.  A missing gradient of o is zeros; a
    gradient without a unit last stride is made contiguous first."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, S0):
        ctx.set_materialize_grads(False)      # an unused S passes None
        o, S, states = forward(r, k, v, logw, u, S0)
        ctx.save_for_backward(r, k, v, logw, u, S0, states)
        return o, S

    @staticmethod
    def backward(ctx, do, dS):
        r, k, v, logw, u, S0, states = ctx.saved_tensors
        if do is None:
            do = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        if do.stride(-1) != 1:
            do = do.contiguous()
        if dS is not None and not dS.is_contiguous():
            dS = dS.contiguous()
        return backward(r, k, v, logw, u, S0, states, do, dS)


def rwkv_scan(r, k, v, logw, u, S0=None):
    """r,k,v: (B,H,T,M) float32 or bf16; logw: (B,H,T,M) float32 (<= 0);
    u: (H,M) float32; S0: (B,H,M,M) float32 or None (zeros) -> (o
    (B,H,T,M) float32, a view of a (B,T,H,M) buffer; S (B,H,M,M)
    float32).  Every input is read through its strides.  Under grad mode
    with an input that requires grad, the results carry K4's backward
    kernel (``RWKVScan``)."""
    check(r, k, v, logw, u, S0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (r, k, v, logw, u, S0)):
        return RWKVScan.apply(r, k, v, logw, u, S0)
    return forward(r, k, v, logw, u, S0)[:2]
