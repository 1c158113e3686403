"""K3 ``moe_gmm`` on the card: the wrapper of ``csrc/moe_gmm.cu``
(replaces the Pallas TPU kernel ``src/repro/kernels/moe_gmm.py``) and of
its backward, ``csrc/moe_gmm_bwd.cu``.

The wrapper checks its inputs and raises on anything the kernel does not
take, allocates the output, launches on the current stream and counts the
launch.  It runs only on CUDA tensors: ``ops.moe_gmm`` sends CPU tensors to
``ref.moe_gmm`` instead.  Under grad mode, with an input that requires
grad, the call goes through ``MoeGmm``, whose backward launches the
backward kernel.

A fake tensor (a trace on ``FakeTensorMode``, inside
``cost.card_path()``) gets its outputs allocated and its call recorded in
``cost``, with ``cost.py``'s count of its work; nothing is launched or
counted as a launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, cost

ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}

launches = 0                    # forward launches since the last reset
bwd_launches = 0                # backward calls (two CUDA launches each)
# backward calls by kernel since the last reset: "wgmma" (TMA and wgmma,
# bf16 with aligned operands), "tc" (mma.sync, the other bf16 calls) and
# "f32" (CUDA cores); see ``_route``
bwd_routes = {"wgmma": 0, "tc": 0, "f32": 0}
_fn = None
_bwd_fn = None


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


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load("moe_gmm_bwd").repro_moe_gmm_bwd
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def check(x, w, rows=None) -> None:
    """Raise ``ValueError`` unless the kernel takes these inputs.  An input
    that requires grad is taken: ``moe_gmm`` differentiates it."""
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
    if not cost.on_card(x) or any(t.device != x.device for t in
                            (w,) + (() if rows is None else (rows,))):
        raise ValueError("all inputs must be on one CUDA device")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def forward(x, w, rows=None):
    """One K3 launch on checked inputs -> y (E,C,F) in x.dtype."""
    global launches
    E, C, D = x.shape
    F = w.shape[2]
    y = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if cost.is_fake(x):                 # a trace: count it, launch nothing;
        # the live rows are not known, so every row is counted
        cost.record("moe_gmm", upper_bound=rows is not None, E=E, C=C,
                    D=D, F=F, dtype=x.dtype)
        return y
    strides = (ctypes.c_longlong * 6)(x.stride(0), x.stride(1), w.stride(0),
                                      w.stride(1), y.stride(0), y.stride(1))
    fn = _kernel()
    with torch.cuda.device(x.device):
        rc = fn(ELEM_BYTES[x.dtype], x.data_ptr(), w.data_ptr(), y.data_ptr(),
                None if rows is None else rows.data_ptr(), E, C, D, F,
                strides, _stream(x))
    if rc != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed: cudaError_t {rc}")
    launches += 1
    return y


def _route(x, w, dy) -> str:
    """The backward kernel a call takes, chosen before the launch from the
    operands alone: "wgmma" for bf16 whose x, w and dy TMA can read (each
    base and each stride but the unit last one a multiple of 16 bytes,
    rows that do not overlap), "tc" for the other bf16 calls, "f32" for
    float32."""
    if x.dtype != torch.bfloat16:
        return "f32"
    for t in (x, w, dy):
        se, sr, sc = t.stride()
        if (t.data_ptr() % 16 or sc != 1 or (2 * sr) % 16 or (2 * se) % 16
                or sr < t.shape[2] or se < t.shape[1] * sr):
            return "tc"
    return "wgmma"


def backward(x, w, dy, rows=None):
    """K3's backward on the card: (dx (E,C,D) in x.dtype, dw (E,D,F) in
    w.dtype) from K3's inputs and the gradient ``dy`` (E,C,F) of its
    output, each read through its strides (unit stride on the last dim).
    dx = dy w^T with rows c >= rows[e] zeros; dw = x^T dy over the rows
    c < rows[e] only; both summed in float32 inside a block.  Two CUDA
    launches, of the kernel ``_route`` picks."""
    global bwd_launches
    check(x, w, rows)
    E, C, D = x.shape
    F = w.shape[2]
    if dy.shape != (E, C, F) or dy.dtype != x.dtype \
            or dy.device != x.device or dy.stride(-1) != 1:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype}: want "
                         f"{(E, C, F)} {x.dtype} on {x.device} with a unit "
                         "stride on F")
    dx = torch.empty((E, C, D), dtype=x.dtype, device=x.device)
    dw = torch.empty((E, D, F), dtype=w.dtype, device=x.device)
    if cost.is_fake(x):                 # a trace: count it, launch nothing
        cost.record("moe_gmm_bwd", upper_bound=rows is not None, E=E,
                    C=C, D=D, F=F, dtype=x.dtype)
        return dx, dw
    st = (ctypes.c_longlong * 10)(*(t.stride(i) for t in (x, w, dy, dx, dw)
                                    for i in range(2)))
    route = _route(x, w, dy)
    fn = _bwd_kernel()
    with torch.cuda.device(x.device):
        rc = fn(ELEM_BYTES[x.dtype], int(route == "wgmma"), x.data_ptr(),
                w.data_ptr(), dy.data_ptr(),
                None if rows is None else rows.data_ptr(), dx.data_ptr(),
                dw.data_ptr(), E, C, D, F, st, _stream(x))
    if rc != 0:
        raise RuntimeError(f"moe_gmm backward launch failed ({route}): "
                           f"cudaError_t {rc}")
    bwd_launches += 1
    bwd_routes[route] += 1
    return dx, dw


class MoeGmm(torch.autograd.Function):
    """K3 with its backward kernel: the forward launches K3 and keeps ``x,
    w, rows``; the backward launches ``csrc/moe_gmm_bwd.cu``.  A ``dy``
    without a unit last stride is made contiguous first."""

    @staticmethod
    def forward(ctx, x, w, rows):
        ctx.save_for_backward(x, w, rows)
        return forward(x, w, rows)

    @staticmethod
    def backward(ctx, dy):
        x, w, rows = ctx.saved_tensors
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        dx, dw = backward(x, w, dy, rows)
        return dx, dw, None


def moe_gmm(x, w, rows=None):
    """x: (E,C,D); w: (E,D,F), both read through their strides (a layer's
    view of a stacked leaf is fine) -> y (E,C,F) in x.dtype, each product
    summed in float32 over all of D.  ``rows`` (E,) int32 on the device, or
    None for all C: rows c >= rows[e] of y are zeros, and no weight is read
    for them.  Under grad mode with an input that requires grad, the result
    carries K3's backward kernel (``MoeGmm``)."""
    check(x, w, rows)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return MoeGmm.apply(x, w, rows)
    return forward(x, w, rows)
