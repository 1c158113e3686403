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
# forward launches and backward calls by kernel since the last reset:
# "wgmma" (TMA and wgmma, bf16 with aligned operands: every backward, the
# ragged forward), "tc" (mma.sync: the other bf16 calls, every dense
# forward) and "f32" (CUDA cores); see ``_route``
routes = {"wgmma": 0, "tc": 0, "f32": 0}
bwd_routes = {"wgmma": 0, "tc": 0, "f32": 0}
_fn = None
_bwd_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("moe_gmm").repro_moe_gmm
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = _build.load("moe_gmm_bwd").repro_moe_gmm_bwd
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def check(x, w, rows=None, starts=None) -> None:
    """Raise ``ValueError`` unless the kernel takes these inputs.  An input
    that requires grad is taken: ``moe_gmm`` differentiates it."""
    ragged = starts is not None
    if ragged and (x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]):
        raise ValueError(f"ragged: want x (M,D), w (E,D,F); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if not ragged and (x.dim() != 3 or w.dim() != 3 or w.shape[0] !=
                       x.shape[0] or w.shape[1] != x.shape[2]):
        raise ValueError(f"want x (E,C,D), w (E,D,F); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if min(x.shape) < 1 or min(w.shape) < 1 or w.shape[0] > 65535:
        raise ValueError(f"shapes {tuple(x.shape)}, {tuple(w.shape)}: want "
                         "nonempty, E <= 65535")
    if x.dtype not in ELEM_BYTES or w.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}/{w.dtype}: want both float32 or "
                         "both bfloat16")
    if x.stride(-1) != 1 or w.stride(-1) != 1:
        raise ValueError("x and w must have a unit stride on their last dim")
    if ragged and rows is None:
        raise ValueError("starts is given only together with rows")
    E = w.shape[0]
    for name, t in (("rows", rows), ("starts", starts)):
        if t is not None and (t.shape != (E,) or t.dtype != torch.int32
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be ({E},) int32 and contiguous; "
                             f"got {tuple(t.shape)} {t.dtype}")
    if not cost.on_card(x) or any(t is not None and t.device != x.device
                                  for t in (w, rows, starts)):
        raise ValueError("all inputs must be on one CUDA device")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _strides(*ts) -> list[int]:
    """The two leading strides of each tensor, (0, the row stride) for a
    packed 2-D one."""
    return [s for t in ts for s in ((0,) if t.dim() == 2 else ())
            + t.stride()[:-1]]


def forward(x, w, rows=None, starts=None):
    """One K3 launch on checked inputs -> y (E,C,F) in x.dtype, or (M,F)
    ragged (allocated as zeros: the rows of no expert stay zero), on the
    kernel ``_fwd_route`` names.  A launch that fails raises: no other
    kernel is tried."""
    global launches
    E, D, F = w.shape
    ragged = starts is not None
    C = x.shape[0] if ragged else x.shape[1]
    y = (torch.zeros((C, F), dtype=x.dtype, device=x.device) if ragged
         else torch.empty((E, C, F), dtype=x.dtype, device=x.device))
    if cost.is_fake(x):                 # a trace: count it, launch nothing;
        # the live rows are not known, so every row is counted
        cost.record("moe_gmm", upper_bound=rows is not None, E=E, C=C,
                    D=D, F=F, dtype=x.dtype, ragged=ragged)
        return y
    strides = (ctypes.c_longlong * 6)(*_strides(x, w, y))
    route = _fwd_route(x, w, ragged)
    fn = _kernel()
    with torch.cuda.device(x.device):
        rc = fn(ELEM_BYTES[x.dtype], int(route == "wgmma"), x.data_ptr(),
                w.data_ptr(), y.data_ptr(), _ptr(rows), _ptr(starts), E, C,
                D, F, strides, _stream(x))
    if rc != 0:
        raise RuntimeError(f"moe_gmm kernel launch failed ({route}): "
                           f"cudaError_t {rc}")
    launches += 1
    routes[route] += 1
    return y


def _route(x, w, dy=None) -> str:
    """The kernel a call takes, chosen before the launch from the operands
    alone: "wgmma" for bf16 whose x, w and (the backward's) dy TMA can read,
    dense (E, rows, cols) or packed (rows, cols) when ragged: each base and
    each stride but the unit last one a multiple of 16 bytes, rows that do
    not overlap; "tc" for the other bf16 calls, "f32" for float32.  The
    dense forward takes "tc" whatever this says (``_fwd_route``)."""
    if x.dtype != torch.bfloat16:
        return "f32"
    for t in (x, w) if dy is None else (x, w, dy):
        *se, sr, sc = t.stride()
        se = se[0] if se else t.shape[0] * sr    # a packed one: E = 1
        if (t.data_ptr() % 16 or sc != 1 or (2 * sr) % 16 or (2 * se) % 16
                or sr < t.shape[-1] or se < t.shape[-2] * sr):
            return "tc"
    return "wgmma"


def _fwd_route(x, w, ragged: bool) -> str:
    """The forward's kernel: ``_route``'s for a ragged call; a dense bf16
    call stays on mma.sync, "tc"."""
    return _route(x, w) if ragged or x.dtype != torch.bfloat16 else "tc"


def backward(x, w, dy, rows=None, starts=None):
    """K3's backward on the card: (dx (E,C,D) in x.dtype, dw (E,D,F) in
    w.dtype) from K3's inputs and the gradient ``dy`` (E,C,F) of its
    output, each read through its strides (unit stride on the last dim).
    dx = dy w^T with rows c >= rows[e] zeros; dw = x^T dy over the rows
    c < rows[e] only; both summed in float32 inside a block.  Ragged
    (``starts``): x (M,D), dy (M,F) and dx (M,D) packed, dx zero on the
    rows of no expert, dw[e] over expert e's rows.  Two CUDA launches, of
    the kernel ``_route`` picks."""
    global bwd_launches
    check(x, w, rows, starts)
    E, D, F = w.shape
    ragged = starts is not None
    want = (x.shape[0], F) if ragged else (E, x.shape[1], F)
    if dy.shape != want or dy.dtype != x.dtype \
            or dy.device != x.device or dy.stride(-1) != 1:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype}: want "
                         f"{want} {x.dtype} on {x.device} with a unit "
                         "stride on F")
    C = want[-2]
    dx = (torch.zeros if ragged else torch.empty)(
        x.shape, dtype=x.dtype, device=x.device)
    dw = torch.empty((E, D, F), dtype=w.dtype, device=x.device)
    if cost.is_fake(x):                 # a trace: count it, launch nothing
        cost.record("moe_gmm_bwd", upper_bound=rows is not None, E=E,
                    C=C, D=D, F=F, dtype=x.dtype, ragged=ragged)
        return dx, dw
    st = (ctypes.c_longlong * 10)(*_strides(x, w, dy, dx, dw))
    route = _route(x, w, dy)
    fn = _bwd_kernel()
    with torch.cuda.device(x.device):
        rc = fn(ELEM_BYTES[x.dtype], int(route == "wgmma"), x.data_ptr(),
                w.data_ptr(), dy.data_ptr(), _ptr(rows), _ptr(starts),
                dx.data_ptr(), dw.data_ptr(), E, C, D, F, st, _stream(x))
    if rc != 0:
        raise RuntimeError(f"moe_gmm backward launch failed ({route}): "
                           f"cudaError_t {rc}")
    bwd_launches += 1
    bwd_routes[route] += 1
    return dx, dw


class MoeGmm(torch.autograd.Function):
    """K3 with its backward kernel: the forward launches K3 and keeps ``x,
    w, rows, starts``; the backward launches ``csrc/moe_gmm_bwd.cu``.  A
    ``dy`` without a unit last stride is made contiguous first."""

    @staticmethod
    def forward(ctx, x, w, rows, starts):
        ctx.save_for_backward(x, w, rows, starts)
        return forward(x, w, rows, starts)

    @staticmethod
    def backward(ctx, dy):
        x, w, rows, starts = ctx.saved_tensors
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        dx, dw = backward(x, w, dy, rows, starts)
        return dx, dw, None, None


def moe_gmm(x, w, rows=None, starts=None):
    """x: (E,C,D); w: (E,D,F), both read through their strides (a layer's
    view of a stacked leaf is fine) -> y (E,C,F) in x.dtype, each product
    summed in float32 over all of D.  ``rows`` (E,) int32 on the device, or
    None for all C: rows c >= rows[e] of y are zeros, and no weight is read
    for them.  Ragged, with ``starts`` (E,) int32 beside ``rows``: x is one
    packed (M,D) buffer, expert e's rows starts[e] .. starts[e] + rows[e]
    (not overlapping), y (M,F) with zeros on the rows of no expert; each
    row is multiplied once.  Under grad mode with an input that requires
    grad, the result carries K3's backward kernel (``MoeGmm``)."""
    check(x, w, rows, starts)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return MoeGmm.apply(x, w, rows, starts)
    return forward(x, w, rows, starts)
