"""AdamW's update on the card: the wrapper of ``csrc/adamw.cu``.

No Pallas kernel stands behind it: the JAX package leaves its optimizer to
XLA (``src/repro/train/optimizer.py``).  One step of a leaf is two passes
over it (the design note in the source): ``sumsq`` is the first, run on
every gradient before the global norm is known; ``update`` is the second,
once the clip scale is.

The wrapper checks its inputs and raises on anything the kernels do not
take, allocates the scratch (one float32 partial a block; nothing the size
of the leaf), launches on the current stream and counts one launch a leaf
updated.  It runs only on CUDA tensors: ``ops.adamw_sumsq`` and
``ops.adamw_update`` send CPU tensors to ``ref`` instead.  The scale,
learning rate and bias corrections stay 0-d float32 tensors on the device,
read by the kernels: nothing waits on the host.

A fake tensor (a trace on ``FakeTensorMode``, inside ``cost.card_path()``)
gets its outputs allocated and its update recorded in ``cost``, with
``cost.py``'s count of its work; nothing is launched or counted as a
launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, cost

launches = 0                    # leaves updated since the last reset
_sumsq_fn = None
_apply_fn = None

THREADS = 256                   # a block (csrc/adamw.cu kThreads)
VEC = 8                         # elements a thread where pointers align
PARTS = 4096                    # block partials of pass 1: above any grid
                                # the card holds at once (132 SMs x 8)
DTYPES = (torch.bfloat16, torch.float32)


def _lib():
    global _sumsq_fn, _apply_fn
    if _sumsq_fn is None:
        lib = _build.load("adamw")
        fn = lib.repro_adamw_sumsq
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ap = lib.repro_adamw_apply
        ap.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 6
                       + [ctypes.c_void_p])
        ap.restype = ctypes.c_int
        _sumsq_fn, _apply_fn = fn, ap
    return _sumsq_fn, _apply_fn


def _vec(*ts) -> int:
    """8 elements a thread where every pointer is 16-byte aligned, else 1."""
    return VEC if all(t.data_ptr() % 16 == 0 for t in ts) else 1


def _check_leaf(t, what: str) -> None:
    """Raise ``ValueError`` unless the kernels take tensor ``t``: nonempty,
    bf16 or float32, contiguous, on the card."""
    if t.numel() < 1 or t.dtype not in DTYPES or not t.is_contiguous():
        raise ValueError(f"{what} {tuple(t.shape)} {t.dtype}: want a "
                         "nonempty contiguous bfloat16 or float32 tensor")
    if not cost.on_card(t):
        raise ValueError(f"{what} on {t.device}: want a CUDA tensor")


def check(p, g, mu, nu) -> None:
    """Raise ``ValueError`` unless the kernels take this leaf: p, g, mu and
    nu each as ``_check_leaf`` asks, all of p's shape and on its device, mu
    and nu of one dtype."""
    for t, what in ((p, "p"), (g, "g"), (mu, "mu"), (nu, "nu")):
        _check_leaf(t, what)
    if any(t.shape != p.shape for t in (g, mu, nu)) or mu.dtype != nu.dtype:
        raise ValueError(f"p {tuple(p.shape)}, g {tuple(g.shape)}, mu "
                         f"{tuple(mu.shape)} {mu.dtype}, nu "
                         f"{tuple(nu.shape)} {nu.dtype}: want g, mu and nu "
                         "of p's shape, mu and nu of one dtype")
    if any(t.device != p.device for t in (g, mu, nu)):
        raise ValueError("g, mu and nu must be on p's device")


def _check_scalars(p, *ts) -> None:
    for t in ts:
        if t.dtype != torch.float32 or t.numel() != 1 \
                or t.device != p.device:
            raise ValueError(f"scale, lr, bc1 and bc2: want 0-d float32 on "
                             f"{p.device}; got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")


def sumsq(g):
    """Pass 1 of gradient leaf ``g``: its sum of squares, a 0-d float32
    tensor."""
    _check_leaf(g, "g")
    sq = torch.empty((), dtype=torch.float32, device=g.device)
    if cost.is_fake(g):                 # a trace: the update records it
        return sq
    fn, _ = _lib()
    parts = torch.empty(PARTS, dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(g.data_ptr(), int(g.dtype == torch.float32), g.numel(),
                _vec(g), parts.data_ptr(), PARTS, sq.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"adamw sumsq launch failed: cudaError_t {rc}")
    return sq


def update(p, g, mu, nu, scale, lr, bc1, bc2, *, b1: float, b2: float,
           eps: float, wd: float) -> None:
    """Pass 2 of leaf ``p`` in place, after ``sumsq``: with g' = scale g,
    mu <- b1 mu + (1 - b1) g', nu <- b2 nu + (1 - b2) g' g', p <- p - lr
    ((mu / bc1) / (sqrt(nu / bc2) + eps) + wd p); ``scale``, ``lr``,
    ``bc1`` and ``bc2`` 0-d float32 on p's device."""
    global launches
    check(p, g, mu, nu)
    _check_scalars(p, scale, lr, bc1, bc2)
    if cost.is_fake(p):                 # a trace: count it, launch nothing
        cost.record("adamw", n=p.numel(), p_dtype=p.dtype, g_dtype=g.dtype,
                    m_dtype=mu.dtype)
        return
    _, fn = _lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = fn(g.data_ptr(), int(g.dtype == torch.float32), p.data_ptr(),
                int(p.dtype == torch.float32), mu.data_ptr(), nu.data_ptr(),
                int(mu.dtype == torch.float32), p.numel(), _vec(g, p, mu, nu),
                scale.data_ptr(), lr.data_ptr(), bc1.data_ptr(),
                bc2.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps, wd, stream)
    if rc != 0:
        raise RuntimeError(f"adamw update launch failed: cudaError_t {rc}")
    launches += 1
