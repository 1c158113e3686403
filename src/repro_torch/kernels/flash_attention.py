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
import math

import torch

from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 160, 256)  # instantiated in the CUDA sources

launches = 0                    # forward launches since the last reset
bwd_launches = 0                # backward calls (three CUDA launches each,
                                # four when _dkdv_splits gives more than 1)
# backward calls by kernel since the last reset: "wgmma" (TMA and wgmma,
# bf16 at hd 128 with aligned operands), "tc" (mma.sync, the other bf16
# calls at hd <= 128), "wide" (mma.sync with 8 warps, hd 160 and 256) and
# "cc" (CUDA cores, float32); see ``_bwd_route``
bwd_routes = {"wgmma": 0, "tc": 0, "wide": 0, "cc": 0}
SMS = 132                       # streaming multiprocessors of an H100 SXM
DKDV_ROWS = 64                  # keys of one dk / dv block (tc, wide, cc)
WGMMA_ROWS = 128                # keys of one dk / dv block on wgmma
WGMMA_HEAD_DIM = 128            # the head dim the wgmma kernels take
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
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                       + [ctypes.c_int] * 10
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


def _bhr_strides(t) -> list[int]:
    """The batch, head and row strides of a (B, heads, rows, hd) tensor; a
    dim of size 1 (never stepped over) gets the stride it would have if it
    were packed against the next one, so that every stride a TMA map is
    given is a real step in memory."""
    st = list(t.stride()[:3])
    inner = t.shape[3]
    for i in (2, 1, 0):
        if t.shape[i] == 1:
            st[i] = inner
        inner = st[i] * t.shape[i]
    return st


def _strides(*ts):
    """The batch, head and row strides of each (B, heads, rows, hd) tensor,
    as the C array the kernels take."""
    flat = [s for t in ts for s in _bhr_strides(t)]
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


def _bwd_route(q, k, v, dout) -> str:
    """The backward kernels a call takes, chosen before the launch from the
    operands alone: "cc" for float32, "wide" for bf16 at hd 160 and 256,
    "wgmma" for bf16 at hd 128 whose q, k, v and dout TMA can read (each
    base, and the batch, head and row strides of every dim longer than 1,
    a positive multiple of 16 bytes), "tc" for the other bf16 calls."""
    if q.dtype != torch.bfloat16:
        return "cc"
    hd = q.shape[3]
    if hd > 128:
        return "wide"
    if hd != WGMMA_HEAD_DIM:
        return "tc"
    for t in (q, k, v, dout):
        if t.data_ptr() % 16 or t.stride(3) != 1 or any(
                n > 1 and (st <= 0 or (2 * st) % 16)
                for n, st in zip(t.shape[:3], t.stride()[:3])):
            return "tc"
    return "wgmma"


def _dkdv_splits(B: int, Hkv: int, S: int, H: int, hd: int, dtype,
                 rows: int = DKDV_ROWS) -> int:
    """How many blocks share the G = H / Hkv query heads of one kv head in
    the dk / dv launch, whose blocks own ``rows`` keys each (WGMMA_ROWS on
    the wgmma route, else DKDV_ROWS).  The rule counts the launch's work
    in units of 64 keys (a wgmma block's two consumer warpgroups own 64
    keys each, as an mma.sync block does): 1 where the B * Hkv * ceil(S /
    rows) * rows / 64 units of one split fill two waves of the card's SMs,
    else the least divisor of G whose units fill four, or G: under a causal
    mask a block's work falls with its key tile, and more, shorter blocks
    even the SMs out.  ``chip_smoke.py``'s ``k2_bwd_splits`` lines time
    every choice at recurrentgemma-9b's shape (8 is the fastest) and the
    MoE's (1 is: its 256 wgmma blocks take longer split, PERF.md §6).
    float32 takes 1 (its kernels are parity checks).  ``hd`` does not
    change the rule: every bf16 head dim takes it."""
    G = H // Hkv
    blocks = B * Hkv * math.ceil(S / rows) * (rows // DKDV_ROWS)
    if dtype != torch.bfloat16 or blocks >= 2 * SMS:
        return 1
    return next(d for d in range(1, G + 1)
                if G % d == 0 and (blocks * d >= 4 * SMS or d == G))


def _bwd_plan(q, k, v, dout) -> tuple[str, int]:
    """(route, splits) of a backward call: the kernels ``_bwd_route``
    picks, and ``_dkdv_splits`` counted in that route's key tiles."""
    route = _bwd_route(q, k, v, dout)
    B, H, _, hd = q.shape
    splits = _dkdv_splits(B, k.shape[1], k.shape[2], H, hd, q.dtype,
                          WGMMA_ROWS if route == "wgmma" else DKDV_ROWS)
    return route, splits


def backward(q, k, v, out, lse, dout, *, causal: bool = True,
             window: int = 0):
    """K2's backward on the card: (dq (B,H,T,hd), dk, dv (B,Hkv,S,hd)) in
    q.dtype, from K2's inputs, its ``out`` and ``lse`` and the gradient
    ``dout`` of ``out``, each read through its strides.  Three CUDA
    launches, of the kernels ``_bwd_route`` picks: D = rowsum(dout * out),
    then dk / dv, then dq (the formula of ``ref.attention_backward``);
    where ``_dkdv_splits`` splits each group's heads over several blocks,
    their float32 partial sums go to a workspace and a fourth launch adds
    them in a fixed order."""
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
    route, splits = _bwd_plan(q, k, v, dout)
    ws = None if splits == 1 else torch.empty(
        (2, splits, B, Hkv, S, hd), dtype=torch.float32, device=q.device)
    fn = _bwd_kernel()
    with torch.cuda.device(q.device):
        rc = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                D.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                None if ws is None else ws.data_ptr(), B, H, Hkv, T, S, hd,
                int(causal), window, splits, int(route == "wgmma"),
                _strides(q, k, v, out, dout), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed "
                           f"({route}): cudaError_t {rc}")
    bwd_launches += 1
    bwd_routes[route] += 1
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
